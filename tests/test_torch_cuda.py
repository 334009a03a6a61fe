"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``cuda`` and skips where there is no CUDA
device (a CUDA kernel has no CPU mode). This file imports neither JAX nor
the reference package, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: ids exact; squared distances rtol=1e-5, atol=1e-5 at these
small widths (fp32 summation order differs between the kernel and the
library GEMM), and exactly equal on integer-grid inputs, where every sum
is exact in fp32. ``pairwise_sq_l2`` and ``topk_l2`` share one distance
tile: self-distances are exactly 0, and the top-k kernel's ids and
distances equal ``stable_topk`` of the pairwise kernel's bit for bit. ``quant_lb2``: int8 bounds bit-equal to the plain
version (the cross term is an exact integer sum and the epilogue rounds
in the same order); bf16 bounds within 1e-3 * sqrt(|q|^2 + |p|^2) of the
plain version's (sum order of the cross term, a quarter of the slack
that covers it); for both, +inf exactly where invalid and no bound above
the exact squared distance. ``lpgf_force``: quarter-integer points make
every distance exact, so both sides take the same ring decisions; F
within 1e-5 of its largest entry and W rtol 1e-5 (sum order). On
Gaussian points its stored squared distances are symmetric and equal
the pairwise kernel's bit for bit, its weights equal the plain law's on
those distances bit for bit, and F and W are held to the plain formula
fed the same distances, to the same tolerances; two calls give the same
bits. Beside NaN rows its per-tile minima, d1 and weights keep NaN
where the plain version's do and their bits elsewhere.
The sharded beam loop (S = 2 and 8 on the one card) returns the
single-device loop's rows, ids and order, and distances (bit for bit in
fp32; in int8 within rtol 1e-6, the rescue's batched product).
``flash_attention`` (both routes, the SIMT kernel and the wgmma one;
the SIMT kernel also at its block edges, windows inside a tile, strided
rows, bf16 widened and olmo-1b's width, ``SIMT_CASES``):
fp32 outputs within 2e-5 (rtol and atol, the
reference's ``test_flash_sweep`` tolerance: summation order and the
scale applied to q before the dot instead of to the scores after it);
bf16 outputs within 2^-8 |b| + 2^-16 max|v| of b, the plain version's
fp32 result on the same (widened) inputs: one rounding to bf16 plus fp32
summation noise near zero; hymba's shape (bf16, hd 64, window 1024)
among them. ``ServeEngine`` on the card at fp32 returns the CPU's tokens
for the same weights. ``moe``'s index dispatch equals the one-hot
formulation (``chip_smoke.moe_onehot``) on the card, routing identical
and outputs within 2^-8 of their largest magnitude. Reduced xlstm (with
sLSTM blocks) and enc-dec at fp32 on the card against the CPU port on
the same weights within 1e-4 of the largest magnitude (sum order),
tokens equal; their captured CUDA graphs (the sLSTM scan, the decode
step) bit for bit against the same steps run eagerly. Training: a
reduced fp32 step's loss and gradient on the card against the CPU's
(the loss within 1e-5 relative, each leaf within 1e-4 of its largest
magnitude); AdamW updates in fp32, bf16 and int8 state bit for bit
against the CPU's given the card's global norm; ``train()`` in int8
state finite.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import query as Q
from repro_torch.core.lake import MMOTable
from repro_torch.core.platform import MQRLD
from repro_torch.configs import get_config
from repro_torch.kernels import build, flash_attention, fused_topk
from repro_torch.kernels import lpgf_force, pairwise_l2, quant_lb2
from repro_torch.models import params_from_numpy, params_to_numpy
from repro_torch.serve.engine import GenRequest, ServeEngine
from repro_torch.kernels import ref as tref
from repro_torch.utils.quant import plan_tiles

RTOL = ATOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _masked_case(kind, seed=0):
    rng = np.random.default_rng(seed)
    g, c, d, k = 6, 700, 40, 9
    q = _np((g, d), seed)
    p = _np((g, c, d), seed + 1)
    valid = rng.random((g, c)) < 0.7
    if kind == "all_masked":
        valid[0] = False
        valid[3, 20:] = False
    elif kind == "k_gt_c":
        c, k = 11, 16
        p = p[:, :c]
        valid = np.ones((g, c), bool)
    elif kind == "ties":
        q = rng.integers(-2, 3, (g, d)).astype(np.float32)
        p = rng.integers(-2, 3, (g, c, d)).astype(np.float32)
        p[:, c // 2:] = p[:, :c // 2]
    elif kind == "ragged":
        c = 301
        p = p[:, :c]
        valid = valid[:, :c]
    elif kind == "k256":
        k = 256
    elif kind == "k300":
        k = 300
    elif kind == "k1000":
        c, k = 1500, 1000
        p = _np((g, c, d), seed + 1)
        valid = rng.random((g, c)) < 0.8
    elif kind == "k20000":   # past the k whose buffers fit in shared memory
        g, c, d, k = 2, 24000, 8, 20000
        q, p = _np((g, d), seed), _np((g, c, d), seed + 1)
        valid = rng.random((g, c)) < 0.9
    return q, p, valid, k


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(17, 33, 5), (300, 1000, 512),
                                   (64, 4100, 130)])
def test_pairwise_kernel_matches_plain(cuda, m, n, d):
    q = torch.from_numpy(_np((m, d), 1)).to(cuda)
    p = torch.from_numpy(_np((n, d), 2)).to(cuda)
    got = pairwise_l2.pairwise_sq_l2_cuda(q, p)
    want = tref.pairwise_sq_l2(q, p)
    scale = (q * q).sum(1)[:, None] + (p * p).sum(1)[None, :]
    # fp32 dot-product error bound, both sides: 4 * D * u * scale
    assert bool(((got - want).abs() <= 4 * d * 2.0 ** -24 * scale
                 + 1e-6).all())
    gq, gp = torch.round(q * 2), torch.round(p * 2)
    assert torch.equal(pairwise_l2.pairwise_sq_l2_cuda(gq, gp),
                       tref.pairwise_sq_l2(gq, gp))
    assert pairwise_l2.launches > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "all_masked", "k_gt_c", "ties",
                                  "ragged", "k256", "k300", "k1000",
                                  "k20000"])
@pytest.mark.parametrize("with_lb2", [False, True])
def test_topk_masked_kernel_matches_plain(cuda, kind, with_lb2):
    """Every k, with the running buffers in shared memory and, at
    k = 20000, in the global scratch the kernel takes above the k that
    fits."""
    q, p, v, k = _masked_case(kind)
    if kind == "k20000":
        assert build.library("fused_topk").topk_l2_masked_scratch_bytes(
            q.shape[0], q.shape[1], k) > 0
    q, p, v = (torch.from_numpy(x).to(cuda) for x in (q, p, v))
    if kind == "ties":
        lb2 = ((p - q[:, None, :]) ** 2).sum(-1)    # the tightest bound
    else:
        lb2 = 0.5 * ((p - q[:, None, :]) ** 2).sum(-1)
    gd, gi = fused_topk.topk_l2_masked_cuda(
        q, p, v, k, lb2=lb2 if with_lb2 else None)
    wd, wi = tref.topk_l2_masked(q, p, v, k)
    if kind == "ties":
        assert torch.equal(gi, wi) and torch.equal(gd, wd)
    else:
        fin = torch.isfinite(wd)
        assert torch.equal(torch.isfinite(gd), fin)
        torch.testing.assert_close(gd[fin], wd[fin], rtol=RTOL, atol=ATOL)
        assert torch.equal(gi[~fin], wi[~fin])
        # ids equal except between candidates tied within the tolerance
        diff = gi != wi
        assert bool((wd[diff] - gd[diff]).abs().le(ATOL + RTOL *
                                                   wd[diff].abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 17, 256, 300, 1000])
def test_topk_l2_kernel_matches_plain(cuda, k):
    """Integer grid (exact distances, many exact ties) with the queries
    inside the point set, on the route ``route(k)`` names: the register
    route at k <= 2, the rank merge above."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(
        rng.integers(-3, 4, (5000, 24)).astype(np.float32)).to(cuda)
    q = p[torch.arange(0, 5000, 50, device=cuda)].contiguous()
    assert fused_topk.route(k) == ("reg" if k <= 2 else "merge")
    before = dict(fused_topk.topk_l2_launches_by_route)
    gd, gi = fused_topk.topk_l2_cuda(q, p, k)
    wd, wi = tref.topk_l2(q, p, k)
    assert torch.equal(gi, wi)
    assert torch.equal(gd, wd)
    r = fused_topk.route(k)
    assert fused_topk.topk_l2_launches_by_route[r] == before[r] + 1


def _gauss(shape, seed, cuda):
    return torch.from_numpy(_np(shape, seed)).to(cuda)


@pytest.mark.cuda
def test_pairwise_self_distances_are_exactly_zero(cuda):
    """A Gaussian row against itself: the norms and the dot product are
    one fmaf chain over the same staged slices in the same order, so the
    expansion cancels to 0 bit for bit (LPGF masks self pairs by it),
    wherever the row falls in the tile grid."""
    x = _gauss((4096, 512), 3, cuda)
    assert bool((pairwise_l2.pairwise_sq_l2_cuda(x, x).diagonal() == 0)
                .all())
    # the same rows as the queries' tail and the points' head
    got = pairwise_l2.pairwise_sq_l2_cuda(x[1000:].contiguous(),
                                          x[:3100].contiguous())
    assert bool((got.diagonal(offset=1000) == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 17, 256, 300, 1000])
def test_topk_l2_equals_stable_topk_of_pairwise(cuda, k):
    """The top-k kernel forms its distances with the pairwise kernel's
    tile, so on Gaussian inputs its ids and distances equal
    ``stable_topk(pairwise_sq_l2_cuda(q, p), k)`` bit for bit; the
    distances are within the fp32 expansion's error bound, 4 D u (|q|^2
    + |p|^2), of the plain version's. N = 5003 is a multiple of neither
    the 128-point tile nor the split count."""
    q, p = _gauss((300, 512), 5, cuda), _gauss((5003, 512), 6, cuda)
    gd, gi = fused_topk.topk_l2_cuda(q, p, k)
    wd, wi = tref.stable_topk(pairwise_l2.pairwise_sq_l2_cuda(q, p), k)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)
    pd, _ = tref.topk_l2(q, p, k)
    scale = (q * q).sum(1)[:, None] + (p * p).sum(1).max()
    assert bool(((gd - pd).abs() <= 4 * 512 * 2.0 ** -24 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 256, 300, 1000])
def test_topk_l2_lower_index_wins_across_splits(cuda, k):
    """Integer grid with each of four queries' rows copied into every N
    split: all copies tie at 0, and the lower index must win whichever
    split holds it and whatever order the splits merge in (at k = 2 the
    two winners lie in different splits)."""
    rng = np.random.default_rng(k)
    n, d = 20000, 16
    p = rng.integers(-3, 4, (n, d)).astype(np.float32)
    lib = build.library("fused_topk")
    splits = lib.topk_l2_splits(40, n, k, int(k <= fused_topk.REG_K))
    bounds = fused_topk.split_bounds(n, splits)
    assert splits >= 4 and len(bounds) == splits
    q = p[[b for b, _ in bounds][:-5:-1]].copy()
    for j in range(4):
        for b, e in bounds:
            p[min(e - 1, b + 7 + j)] = q[j]
    q = np.concatenate([q, rng.integers(-3, 4, (36, d)).astype(np.float32)])
    qt, pt = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    gd, gi = fused_topk.topk_l2_cuda(qt, pt, k)
    wd, wi = tref.topk_l2(qt, pt, k)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d,k", [(17, 33, 5, 1), (17, 33, 5, 2),
                                     (17, 33, 5, 17), (17, 33, 5, 33),
                                     (129, 5003, 130, 2),
                                     (129, 5003, 130, 300)])
def test_topk_l2_ragged_shapes(cuda, m, n, d, k):
    """Ragged M, N and D (D = 5 and 130 not a multiple of the 64-wide
    slice, 5 not of 4: the 4-byte copies), k up to N."""
    q, p = _gauss((m, d), m, cuda), _gauss((n, d), n, cuda)
    gd, gi = fused_topk.topk_l2_cuda(q, p, k)
    wd, wi = tref.stable_topk(pairwise_l2.pairwise_sq_l2_cuda(q, p), k)
    assert torch.equal(gi, wi) and torch.equal(gd, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 3, 40])
def test_topk_l2_routes_and_split_counts_agree(cuda, splits):
    """Both routes, and any split count (40 splits of 5003 points leave
    each split 128 or 256 points, below k = 300), give the same bits; the
    library's register-route limit is the wrapper's."""
    assert build.library("fused_topk").topk_l2_reg_k() == fused_topk.REG_K
    q, p = _gauss((200, 64), 7, cuda), _gauss((5003, 64), 8, cuda)
    want = tref.stable_topk(pairwise_l2.pairwise_sq_l2_cuda(q, p), 300)
    for k, path in ((1, "reg"), (2, "reg"), (2, "merge"), (300, "merge")):
        gd, gi = fused_topk._launch(q, p, k, path, splits=splits)
        assert torch.equal(gd, want[0][:, :k]) and torch.equal(
            gi, want[1][:, :k]), (k, path)
    with pytest.raises(ValueError, match="no 'reg' route"):
        fused_topk._launch(q, p, 3, "reg")


def _quant_case(kind, precision, cuda, seed=0):
    """(q, codes, cscale, cppq, ceps, valid, exact d2) on the card for
    one edge case of the mixed-precision scan, at a round's shape."""
    rng = np.random.default_rng(seed)
    g, t, cap, d = 8, 24, 64, 512
    if kind == "ragged_d":
        d = 37
    tiles = (rng.normal(size=(t, cap, d)) * 4).astype(np.float32)
    tvalid = np.ones((t, cap), bool)
    tvalid[-1, 40:] = False
    if kind == "constant":
        tiles[3] = 0.0           # the int8 scale floors
        tiles[4] = 2.5           # every row equal
    if kind == "duplicates":
        tiles[1] = tiles[0]
    q = (rng.normal(size=(g, d)) * 4).astype(np.float32)
    q[1] = tiles[2, 5]          # a query on a candidate: distance 0
    sel = np.stack([rng.permutation(t)[:16] for _ in range(g)])
    c = 16 * cap
    valid = (rng.random((g, c)) < 0.8) & tvalid[sel].reshape(g, c)
    if kind == "all_masked":
        valid[0] = False
        valid[5, 100:] = False
    pl = plan_tiles(tiles, tvalid, precision)
    codes = pl.data[sel].reshape(g, c, d)
    cs = pl.scale[sel].repeat_interleave(cap, 1)
    cp = pl.ppq[sel].reshape(g, c)
    ce = pl.eps[sel].repeat_interleave(cap, 1)
    pts = tiles[sel].reshape(g, c, d).astype(np.float64)
    exact = ((pts - q[:, None, :].astype(np.float64)) ** 2).sum(-1)
    to = (lambda x: torch.as_tensor(x).to(cuda).contiguous())
    return (to(q), to(codes), to(cs), to(cp), to(ce), to(valid),
            torch.as_tensor(exact))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["plain", "all_masked", "constant",
                                  "duplicates", "ragged_d"])
@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_quant_lb2_kernel_matches_plain(cuda, kind, precision):
    q, codes, cs, cp, ce, v, exact = _quant_case(kind, precision, cuda)
    got = quant_lb2.quant_lb2_cuda(q, codes, cs, cp, ce, v,
                                   precision=precision)
    want = tref.quant_lb2(q, codes, cs, cp, ce, v, precision=precision)
    assert torch.equal(torch.isinf(got), ~v)
    if precision == "int8":
        assert torch.equal(got, want)
    else:
        mag = ((q * q).sum(1)[:, None] + cp).clamp_min(0)
        err = (got - want).abs()[v]
        assert bool((err <= 1e-3 * mag.sqrt()[v]).all())
    gv = got.cpu().double()[v.cpu()]
    assert bool((gv <= exact[v.cpu()]).all())   # the contract
    assert quant_lb2.launches > 0


def _grid_points(n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-12, 13, (n, d)) * 0.25).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,r_mult", [(300, 40, 7.5), (1000, 512, 7.5),
                                        (1000, 37, 1.5), (4096, 64, 7.5),
                                        (1000, 2048, 7.5), (129, 2048, 1.5)])
def test_lpgf_force_kernel_matches_plain(cuda, n, d, r_mult):
    x = torch.from_numpy(_grid_points(n, d, n + d)).to(cuda)
    x[7] = x[3]                          # a duplicate point
    d2 = tref.pairwise_sq_l2(x, x)
    d2.fill_diagonal_(float("inf"))
    g = float(d2.min(1).values.sqrt().mean())
    gf, gw = lpgf_force.lpgf_force_cuda(x, r_mult * g, g)
    wf, ww = tref.lpgf_force(x, r_mult * g, g)
    scale = float(wf.abs().max()) + 1e-6
    assert float((gf - wf).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(gw, ww, rtol=1e-5, atol=1e-5)
    assert lpgf_force.launches > 0


def _gauss_lpgf_case(n, d, seed, cuda):
    """Gaussian points with a duplicate, and G (mean nearest-neighbour
    distance) from the plain distances; 1 for a single point, which has
    no neighbour."""
    x = torch.from_numpy(_np((n, d), seed)).to(cuda)
    if n == 1:
        return x, 1.0
    x[7] = x[3]
    d2 = tref.pairwise_sq_l2(x, x)
    d2.fill_diagonal_(float("inf"))
    return x, float(d2.min(1).values.sqrt().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,r_mult", [(1000, 512, 7.5), (1000, 37, 1.5),
                                        (300, 2048, 1.5), (4096, 64, 1.5),
                                        (1, 5, 7.5)])
def test_lpgf_force_stored_distances(cuda, n, d, r_mult):
    """Through ``_launch(keep=True)``: the stored squared distances are
    symmetric and equal ``pairwise_sq_l2_cuda(x, x)`` bit for bit (the
    kernel forms each tile pair once and mirrors it); d1, the least of
    each row's per-tile minima, is the row's least distance off the
    diagonal; the weights equal the plain law's on those distances bit
    for bit (the same ring decisions on data that is not a grid); F and W
    agree with the plain formula fed the same distances."""
    x, g = _gauss_lpgf_case(n, d, n + d, cuda)
    gf, gw, s = lpgf_force._launch(x, r_mult * g, g, keep=True)
    d2 = s["d2"]
    assert torch.equal(d2, d2.T)
    assert torch.equal(d2, pairwise_l2.pairwise_sq_l2_cuda(x, x))
    off = d2.clone()
    off.fill_diagonal_(float("inf"))
    d1 = s["pmin"].min(1).values
    assert torch.equal(d1, off.min(1).values)
    want_w, want_d1 = tref.lpgf_weights(d2, r_mult * g, g)
    assert torch.equal(d1, want_d1)
    assert torch.equal(s["w"], want_w)
    assert torch.equal(s["xt"], x.T)
    wf, ww = tref.lpgf_force(x, r_mult * g, g, d2=d2)
    scale = float(wf.abs().max()) + 1e-6
    assert float((gf - wf).abs().max()) <= 1e-5 * scale
    torch.testing.assert_close(gw, ww, rtol=1e-5, atol=1e-5)
    # the weights in place of the distances give the same bits
    f2, w2 = lpgf_force.lpgf_force_cuda(x, r_mult * g, g)
    assert torch.equal(f2, gf) and torch.equal(w2, gw)


@pytest.mark.cuda
def test_lpgf_force_calls_are_bit_identical(cuda):
    """No atomics and every sum in a fixed order: two calls on the same
    points give the same bits."""
    x, g = _gauss_lpgf_case(4096, 512, 11, cuda)
    a = lpgf_force.lpgf_force_cuda(x, 7.5 * g, g)
    b = lpgf_force.lpgf_force_cuda(x, 7.5 * g, g)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_lpgf_force_kernels_do_not_spill(cuda):
    """ptxas reports 0 spill bytes for each of the force field's four
    kernels (the distance tile, the weights, the transpose, w @ x)."""
    spills = build.spill_bytes(build.build_all()["lpgf_force"])
    names = ("lpgf_d2_kernel", "lpgf_weights_kernel", "transpose_kernel",
             "lpgf_wx_kernel")
    assert all(sum(n in f for f in spills) == 1 for n in names), spills
    assert not any(spills.values()), spills


def _nan_equal(a, b) -> bool:
    """Equal values (-0 equal to 0) and NaN in the same places."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def _with_nan_rows(x, rows, one_coordinate=None):
    """A copy of ``x`` with the given rows all NaN, and one more row NaN
    in a single coordinate (the delta's pad rows, a corrupt value)."""
    x = x.clone()
    x[rows] = float("nan")
    if one_coordinate is not None:
        x[one_coordinate, x.shape[1] // 2] = float("nan")
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(17, 33, 5), (300, 1000, 512),
                                   (64, 4100, 130)])
def test_pairwise_kernel_keeps_nan(cuda, m, n, d):
    """Rows with a NaN coordinate give NaN distances, as the plain
    version's clamp keeps them (``fmaxf`` alone would read 0 there: the
    engine's dense V.R pass would then take the delta's NaN pad rows as
    matches). Every other entry keeps its bits: equal to the kernel's
    output without the NaN rows, and on an integer grid equal to the
    plain version."""
    q = _with_nan_rows(_gauss((m, d), m, cuda), [0, m // 2], m - 1)
    p = _with_nan_rows(_gauss((n, d), n, cuda), [1, n - 1], n // 3)
    got = pairwise_l2.pairwise_sq_l2_cuda(q, p)
    want = tref.pairwise_sq_l2(q, p)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    qr = ~torch.isnan(q).any(1)
    pr = ~torch.isnan(p).any(1)
    assert bool(torch.isnan(got[~qr]).all()) and \
        bool(torch.isnan(got[:, ~pr]).all())
    clean = pairwise_l2.pairwise_sq_l2_cuda(q[qr].contiguous(),
                                            p[pr].contiguous())
    assert torch.equal(got[qr][:, pr], clean)
    gq, gp = torch.round(q * 2), torch.round(p * 2)
    assert _nan_equal(pairwise_l2.pairwise_sq_l2_cuda(gq, gp),
                      tref.pairwise_sq_l2(gq, gp))


@pytest.mark.cuda
def test_nan_rows_leave_self_distances_and_symmetry(cuda):
    """The distance tile's laws hold beside NaN rows: a Gaussian row
    against itself is exactly 0, d2(x, x) is symmetric bit for bit, and
    the NaN rows are NaN across; LPGF's stored distances are the pairwise
    kernel's."""
    x = _with_nan_rows(_gauss((1000, 512), 13, cuda), [5, 600], 999)
    d2 = pairwise_l2.pairwise_sq_l2_cuda(x, x)
    ok = ~torch.isnan(x).any(1)
    assert bool((d2.diagonal()[ok] == 0).all())
    assert _nan_equal(d2, d2.T)
    assert bool(torch.isnan(d2[~ok]).all())
    _, _, s = lpgf_force._launch(x, 1.0, 1.0, keep=True)
    assert _nan_equal(s["d2"], d2)


def _tile_row_minima(d2, tile: int = lpgf_force.TILE):
    """Each row's least squared distance over each column tile, self
    excluded, by ``torch.amin`` (which keeps NaN, as the plain version's
    ``torch.min`` does): the plain counterpart of ``lpgf_force``'s
    per-tile minima."""
    off = d2.clone()
    off.fill_diagonal_(float("inf"))
    n = d2.shape[0]
    t = -(-n // tile)
    off = torch.nn.functional.pad(off, (0, t * tile - n),
                                  value=float("inf"))
    return off.view(n, t, tile).amin(2)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1000, 512), (300, 37)])
def test_lpgf_force_keeps_nan(cuda, n, d):
    """Rows with a NaN coordinate: the kernel's minima keep NaN where the
    plain version's do (``fminf`` alone returns the other operand, so
    d1 would be finite and the weights beside a NaN row would not be
    NaN), and keep their bits elsewhere: the per-tile minima equal
    ``torch.amin`` over the kernel's own distances, NaN in the same
    places and the same bits off them; the weights equal the plain law's
    on those distances bit for bit; W and F are NaN where the plain
    formula's are. A radius of 7.5 mean neighbour distances puts
    neighbours inside it, so NaN reaches W through d1. The NaN rows lie
    in the first column tiles, so the last tile's minima stay finite."""
    x, g = _gauss_lpgf_case(n, d, n + d + 1, cuda)
    x = _with_nan_rows(x, [5, 130], 9)
    gf, gw, s = lpgf_force._launch(x, 7.5 * g, g, keep=True)
    want = _tile_row_minima(s["d2"])
    assert bool(torch.isnan(want).any()) and bool(torch.isfinite(want).any())
    assert _nan_equal(s["pmin"], want)
    want_w, want_d1 = tref.lpgf_weights(s["d2"], 7.5 * g, g)
    assert _nan_equal(s["w"], want_w)
    assert _nan_equal(s["pmin"].min(1).values, want_d1)
    wf, ww = tref.lpgf_force(x, 7.5 * g, g, d2=s["d2"])
    assert bool(torch.isnan(ww).any())
    assert torch.equal(torch.isnan(gw), torch.isnan(ww))
    assert torch.equal(torch.isnan(gf), torch.isnan(wf))


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(40, 2), (40, 40), (5003, 2), (5003, 300),
                                 (5003, 1000)])
def test_topk_l2_ranks_nan_rows_last(cuda, n, k):
    """Points with a NaN coordinate rank after every number, in index
    order, and report NaN with their index, as ``ref.topk_l2`` (and
    ``lax.top_k`` of the negated distances) rank them; on both routes,
    and where k reaches into the NaN rows. Half-integer inputs make every
    distance exact, so the plain version's ids and distances are the
    kernel's bit for bit."""
    nan_rows = list(range(0, n, 3)) if n == 40 else [2, 77, 4000]
    q = torch.round(_gauss((65, 64), k, cuda) * 2) / 2
    p = _with_nan_rows(torch.round(_gauss((n, 64), n, cuda) * 2) / 2,
                       nan_rows, n - 2)
    gd, gi = fused_topk.topk_l2_cuda(q, p, k)
    wd, wi = tref.stable_topk(pairwise_l2.pairwise_sq_l2_cuda(q, p), k)
    assert torch.equal(gi, wi) and _nan_equal(gd, wd)
    pd, pi = tref.topk_l2(q, p, k)
    assert torch.equal(gi, pi) and _nan_equal(gd, pd)
    if n == 40 and k == 40:
        assert bool(torch.isnan(gd[:, -len(nan_rows) - 1:]).all())


@pytest.mark.cuda
def test_topk_masked_nan_candidates_match_plain(cuda):
    """A valid candidate with a NaN coordinate ranks after the invalid
    ones and reports (NaN, -1), as the plain version's ``isfinite``
    test gives it."""
    q, p, valid, _ = _masked_case("plain")
    p[:, 3] = np.nan
    p[2, 10:20, 4] = np.nan
    valid[:, 3] = True
    qt, pt = torch.from_numpy(q).to(cuda), torch.from_numpy(p).to(cuda)
    vt = torch.from_numpy(valid).to(cuda)
    k = 700
    gd, gi = fused_topk.topk_l2_masked_cuda(qt, pt, vt, k)
    wd, wi = tref.topk_l2_masked(qt, pt, vt, k)
    assert torch.equal(gi, wi)
    assert torch.equal(torch.isnan(gd), torch.isnan(wd))
    assert bool(torch.isnan(gd).any())


@pytest.mark.cuda
def test_ingest_on_card():
    """Append, query and fold on the card: the delta's NaN pad rows answer
    nothing (no row id at or past ``n_base + m``), every row of both
    loops in all three precisions is the oracle's, the union's re-rank
    scales cover the delta's tiles, and after the fold the same holds
    over the merged index."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(12, 32)).astype(np.float32) * 6
    vec = (centers[rng.integers(0, 12, 6000)]
           + rng.normal(size=(6000, 32))).astype(np.float32)
    price = rng.uniform(0, 100, 6000).astype(np.float32)
    p = MQRLD(MMOTable("t").add_vector("v", vec).add_numeric("price", price),
              seed=0)
    p.prepare(min_leaf=32, max_leaf=256)
    nb = p.n_base
    m = 700          # capacity 1024: 324 NaN pad rows
    new = (centers[rng.integers(0, 12, m)] * 1.5
           + rng.normal(size=(m, 32))).astype(np.float32)
    new[0] = p.table.vector["v"][11] + 1e-3
    p.append(numeric={"price": rng.uniform(0, 100, m).astype(np.float32)},
             vector={"v": new}, fold=False)
    view = p.view()
    tab = view.vector["v"]
    radius = float(np.sqrt(((tab[:64] - tab[64:128]) ** 2).sum(1)).min())

    def batch():
        out = []
        for i in (11, 500, nb, nb + 350):
            v = tab[i]
            out += [Q.VK.of("v", v, 20),
                    Q.And.of(Q.NR("price", 25, 75), Q.VK.of("v", v, 20)),
                    Q.And.of(Q.VR.of("v", v, radius), Q.NR("price", 5, 95)),
                    Q.VR.of("v", v, 4 * radius)]
        return out
    qs = batch()
    for prec in ("fp32", "int8", "bf16"):
        eng = p.engine(precision=prec)
        assert eng.n == nb + 1024 and eng.delta_rows == m
        assert eng.vec_max2["v"] >= float(
            (new.astype(np.float64) ** 2).sum(1).max())
        for geom in (eng.geom["v"], eng.geom_dev["v"]):
            dr = geom.radius[-eng.delta_tiles:]
            assert geom.rad_max >= float(dr.max())
        for dl in (True, False):
            got, _ = p.session(precision=prec).plan(
                qs, device_loop=dl).execute()
            for q, g in zip(qs, got):
                np.testing.assert_array_equal(g, p.oracle(q))
                assert g.max(initial=-1) < nb + m
            assert nb in got[0].tolist()
    assert p.fold() == m and p.table.n_rows == nb + m
    for dl in (True, False):
        got, _ = p.session().plan(qs, device_loop=dl).execute()
        for q, g in zip(qs, got):
            np.testing.assert_array_equal(g, p.oracle(q))


@pytest.fixture(scope="module")
def card_platform():
    """A small platform prepared on the card (N above LPGF's 4096-point
    force-kernel branch: the tiled path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    centers = rng.normal(size=(12, 16)).astype(np.float32) * 6
    vec = (centers[rng.integers(0, 12, 5000)]
           + rng.normal(size=(5000, 16))).astype(np.float32)
    price = rng.uniform(0, 100, 5000).astype(np.float32)
    p = MQRLD(MMOTable("t").add_vector("v", vec).add_numeric("price", price),
              seed=0)
    p.prepare(min_leaf=32, max_leaf=256)
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 300, 1000])
def test_engine_rows_equal_oracle_on_card(card_platform, k):
    """At any k, both beam loops on the card return the oracle's rows."""
    p = card_platform
    tab = p.table.vector["v"]
    qs = [Q.VK.of("v", tab[i], k) for i in (0, 1234, 4321)]
    qs.append(Q.And.of(Q.NR("price", 25, 75), Q.VK.of("v", tab[7], k)))
    for device_loop in (True, False):
        got, _ = p.session().plan(qs, device_loop=device_loop).execute()
        for q, g in zip(qs, got):
            np.testing.assert_array_equal(g, p.oracle(q))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["int8", "bf16"])
def test_mp_engine_rows_equal_oracle_on_card(card_platform, precision):
    """The mixed-precision scan on the card, both loops: the oracle's
    rows, the fp32 session's rows, and reduced-precision work counted."""
    p = card_platform
    tab = p.table.vector["v"]
    qs = [Q.VK.of("v", tab[i], 20) for i in (0, 1234, 4321)]
    qs.append(Q.And.of(Q.NR("price", 25, 75), Q.VK.of("v", tab[7], 20)))
    qs.append(Q.And.of(Q.VR.of("v", tab[9], 6.0), Q.VK.of("v", tab[9], 9)))
    for device_loop in (True, False):
        want, _ = p.session(precision="fp32").plan(
            qs, device_loop=device_loop).execute()
        got, st = p.session(precision=precision).plan(
            qs, device_loop=device_loop).execute()
        for q, g, w in zip(qs, got, want):
            np.testing.assert_array_equal(g, p.oracle(q))
            np.testing.assert_array_equal(g, w)
        assert 0 < st.mp_rescued <= st.mp_scanned


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 8])
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_batched_knn_sharded_on_card(card_platform, shards, precision):
    """The sharded beam loop on the card (all shards on the one card):
    rows and distances equal the single-device loop's, with and without a
    mask, at k = 20 and 300; the sharded engine's batch equals the
    single-device engine's, ids and order, and the oracle's; and the
    distance, top-k and (int8) lower-bound kernels launched within the
    sharded calls (the single-device references' launches not counted)."""
    from repro_torch.core.engine import (EngineStats, batched_knn_device,
                                         batched_knn_sharded)
    p = card_platform
    eng = p.engine(shards=shards, precision=precision)
    single = p.engine(shards=0, precision=precision)
    tab = p.table.vector["v"]
    qs = torch.as_tensor(tab[[0, 1234, 4321, 77]] + 0.05, device="cuda")
    mask = torch.as_tensor(p.table.numeric["price"] < 40.0, device="cuda")
    planes = single.vec_planes_dev.get("v")
    counted = [0, 0, 0]     # launches inside the sharded calls only

    def sharded(call):
        before = (pairwise_l2.launches, fused_topk.topk_l2_masked_launches,
                  quant_lb2.launches)
        out = call()
        torch.cuda.synchronize()
        for i, n in enumerate((pairwise_l2.launches,
                               fused_topk.topk_l2_masked_launches,
                               quant_lb2.launches)):
            counted[i] += n - before[i]
        return out

    for masks in (None, mask[None].expand(len(qs), -1).contiguous()):
        for k in (20, 300):
            st = EngineStats()
            ds, rs = sharded(lambda: batched_knn_sharded(
                eng.sharded_dev, eng.geom_dev["v"], eng.vec_tiles_dev["v"],
                qs, k, masks=masks, beam=16,
                planes=eng.vec_planes_dev.get("v"), precision=precision,
                stats=st))
            dd, rd = batched_knn_device(
                single.geom_dev["v"], single.vec_tiles_dev["v"], qs, k,
                masks=masks, beam=16, planes=planes, precision=precision)
            np.testing.assert_array_equal(rs, rd)
            if precision == "fp32":    # one kernel forms both sides' bits
                np.testing.assert_array_equal(ds, dd)
            else:   # the rescue's batched product: its shape may pick the
                #     library kernel, so allow its fp32 rounding
                np.testing.assert_allclose(ds, dd, rtol=1e-6, atol=0)
            assert st.rows_scanned > 0
    qb = [Q.VK.of("v", tab[i], 20) for i in (0, 1234, 4321)]
    qb.append(Q.And.of(Q.NR("price", 25, 75), Q.VK.of("v", tab[7], 20)))
    qb.append(Q.And.of(Q.VR.of("v", tab[9], 6.0), Q.VK.of("v", tab[9], 9)))
    want, _ = p.session(shards=0, precision=precision).plan(qb).execute()
    got, st = sharded(lambda: p.session(
        shards=shards, precision=precision).plan(qb).execute())
    assert st.shards == shards
    for q, g, w in zip(qb, got, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p.oracle(q))
    assert counted[0] > 0, counted
    assert counted[1 if precision == "fp32" else 2] > 0, counted


@pytest.mark.cuda
@pytest.mark.parametrize("k", [20, 300])
def test_batched_executor_on_card(card_platform, k):
    """``BatchedExecutor`` on the card launches ``topk_l2_masked`` and
    returns the brute force's rows over the enhanced features (exactly
    equal distances by row id), and the host executor's."""
    from repro_torch.core.index import BatchedExecutor, HostExecutor
    p = card_platform
    data = p.enhanced
    qs = data[[0, 1234, 4321]]
    before = fused_topk.topk_l2_masked_launches
    _, rows, _ = BatchedExecutor(p.tree, data).knn(qs, k)
    assert fused_topk.topk_l2_masked_launches > before
    host = HostExecutor(p.tree, data)
    for q, r in zip(qs, rows):
        d2 = np.sum((data - q[None, :]) ** 2, axis=1)
        np.testing.assert_array_equal(r, np.lexsort(
            (np.arange(len(data)), d2))[:k])
        np.testing.assert_array_equal(r, host.knn(q, k)[0])


@pytest.mark.cuda
def test_scalar_fallback_and_calibration_on_card(card_platform):
    """A batch with a query the engine cannot plan takes the scalar path
    beside the card's engine, and a calibrated model on the card leaves
    every row the oracle's."""
    p = card_platform
    tab = p.table.vector["v"]
    qs = [Q.VK.of("v", tab[3], 10),
          Q.And.of(Q.Or.of(Q.VK.of("v", tab[5], 4), Q.NR("price", 0, 1)),
                   Q.NR("price", 0, 60)),
          Q.And.of(Q.VR.of("v", tab[9], 6.0), Q.NR("price", 20, 80))]
    plan = p.session().plan(qs)
    assert plan.explain()["n_scalar"] == 1
    for q, g in zip(qs, plan.execute()[0]):
        np.testing.assert_array_equal(g, p.oracle(q))
    saved = p.cost_model
    try:
        model = p.calibrate(batch=4, repeats=1)
        assert model.host["backend"] == "cuda" and model.calibrated()
        for q, g in zip(qs, p.session().plan(qs).execute()[0]):
            np.testing.assert_array_equal(g, p.oracle(q))
    finally:
        p.cost_model = saved


def _dispatch_case(p, precision):
    """An engine of ``precision`` on ``p`` and a batch's V.K jobs, the
    predicate masks already taken (host numpy, a sync of their own)."""
    from repro_torch.core.engine import EngineStats
    eng = p.engine(precision=precision)
    tab = p.table.vector["v"]
    qs = [Q.VK.of("v", tab[i], 20) for i in (0, 1234, 4321)]
    qs.append(Q.And.of(Q.NR("price", 25, 75), Q.VK.of("v", tab[7], 20)))
    stats = EngineStats(queries=len(qs))
    pred = eng._stage_batch(qs, stats, True, None)
    jobs, _, _ = eng._plan_jobs(qs, pred, None)
    return eng, qs, pred, jobs, stats


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "int8", "bf16"])
def test_dispatch_takes_no_host_sync(card_platform, precision):
    """The enqueue half of ``_dispatch_jobs`` on the device loop (the
    uploads through pinned memory, the prologue and first round, the
    copies back into pinned memory) runs under
    ``set_sync_debug_mode("error")``, which raises at any host sync; its
    finish gives ``execute_batch``'s rows."""
    eng, qs, pred, jobs, stats = _dispatch_case(card_platform, precision)
    want, _ = eng.execute_batch(qs, device_loop=True)     # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend = eng._dispatch_jobs(jobs, stats, True, eager=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = eng._finish_walk(qs, pred, jobs, pend.finish())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # the guard works: a blocking read-back does raise under it
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            eng.bucket_rows[:1].cpu()
    finally:
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.cuda
def test_first_round_lands_in_pinned_memory(card_platform, monkeypatch):
    """The first round's read-backs are non-blocking copies into pinned
    host buffers, with an event behind them."""
    from repro_torch.core import engine as teng
    eng, qs, pred, jobs, stats = _dispatch_case(card_platform, "fp32")
    made = []
    real = teng._to_host_async

    def spy(t):
        h = real(t)
        made.append((t.is_cuda, h.is_pinned(), h.device.type))
        return h
    monkeypatch.setattr(teng, "_to_host_async", spy)
    pend = eng._dispatch_jobs(jobs, stats, True, eager=False)
    assert len(made) == 6 and all(m == (True, True, "cpu") for m in made)
    got = eng._finish_walk(qs, pred, jobs, pend.finish())
    for q, g in zip(qs, got):
        np.testing.assert_array_equal(g, card_platform.oracle(q))


@pytest.mark.cuda
def test_small_table_prepare_goes_through_lpgf_force(cuda):
    """A table of at most 4096 rows takes LPGF's force kernel in
    prepare(); its queries still return the oracle's rows."""
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(8, 32)).astype(np.float32) * 6
    vec = (centers[rng.integers(0, 8, 3000)]
           + rng.normal(size=(3000, 32))).astype(np.float32)
    before = lpgf_force.launches
    p = MQRLD(MMOTable("s").add_vector("v", vec), seed=0)
    p.prepare(min_leaf=32, max_leaf=256)
    assert lpgf_force.launches > before
    qs = [Q.VK.of("v", p.table.vector["v"][i], 10) for i in (0, 99, 2999)]
    got, _ = p.session().plan(qs).execute()
    for q, g in zip(qs, got):
        np.testing.assert_array_equal(g, p.oracle(q))


# ------------------------------------------------- re-optimization
def _reopt_platform():
    """A 5,000 x 16 platform on the card with a recorded workload."""
    rng = np.random.default_rng(2)
    centers = rng.normal(size=(12, 16)).astype(np.float32) * 6
    vec = (centers[rng.integers(0, 12, 5000)]
           + rng.normal(size=(5000, 16))).astype(np.float32)
    price = rng.uniform(0, 100, 5000).astype(np.float32)
    p = MQRLD(MMOTable("r").add_vector("v", vec).add_numeric("price", price),
              seed=0)
    p.prepare(min_leaf=32, max_leaf=256)
    qs = [Q.VK.of("v", vec[i] + 0.01, 10) for i in range(0, 4000, 500)]
    for q in qs:
        p.execute(q)                         # records the workload
    return p, qs


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_swap_of_prewarmed_generation_on_card(cuda, monkeypatch, precision):
    """A generation warmed by the controller on the card swaps in with
    its engine: the first batch after the swap is a plan-cache hit,
    builds no engine and quantizes nothing (``plan_tiles`` 0 times), and
    its rows are the oracle's."""
    from repro_torch.core import engine as teng
    from repro_torch.core.reopt import ReoptController
    from repro_torch.utils import quant
    p, qs = _reopt_platform()
    sess = p.session(precision=precision)
    ctl = ReoptController(p, session=sess)
    gen = p.build_generation(theta=[0.1, -0.05, 0.02, 0.0],
                             delta_scales=[0.05, 0.0, -0.05, 0.0])
    ctl._warm_generation(gen)
    assert ctl.warm_errors == [] and len(gen.engines) == 1
    p.swap(gen)
    built, planned = [], []
    real_init, real_plan = teng.HybridEngine.__init__, quant.plan_tiles
    monkeypatch.setattr(teng.HybridEngine, "__init__",
                        lambda self, *a, **kw: built.append(1)
                        or real_init(self, *a, **kw))
    monkeypatch.setattr(quant, "plan_tiles",
                        lambda *a, **kw: planned.append(1)
                        or real_plan(*a, **kw))
    def scans():      # the int8 scan's kernel is quant_lb2
        return quant_lb2.launches if precision == "int8" \
            else fused_topk.topk_l2_masked_launches
    hits = sess.cache_hits
    before = scans()
    got, _ = sess.plan(qs[:4]).execute()
    assert sess.cache_hits == hits + 1
    assert built == [] and planned == []
    assert scans() > before
    for q, g in zip(qs[:4], got):
        np.testing.assert_array_equal(g, p.oracle(q))


@pytest.mark.cuda
def test_pipelined_server_steps_reopt_only_when_drained(cuda):
    """At depth 2 on the card the server never steps its controller while
    a chunk is in flight (a chunk's ``PendingBatch`` waiting on its CUDA
    event), and ``flush()`` never steps it."""
    from repro_torch.serve.engine import RetrievalRequest, RetrievalServer
    p, _ = _reopt_platform()

    class Stub:
        def embed(self, tokens):
            rows = np.asarray(tokens)[:, 0] % p.table.n_rows
            return p.table.vector["v"][rows] + 0.01

    t = [0.0]
    srv = RetrievalServer(p, Stub(), batch_size=4, pipeline_depth=2,
                          clock=lambda: t[0])

    class Log:
        session = None
        seen = []

        def step(self):
            self.seen.append(srv.inflight_chunks)
            return "idle"

        def status(self):
            return {}

    srv.attach_reopt(Log())
    futs = []
    for i in range(24):
        futs.append(srv.submit(RetrievalRequest(
            tokens=np.asarray([i * 7, 1], np.int32), attr="v", k=10)))
        t[0] += 0.001
        srv.poll()
    n = len(Log.seen)
    srv.flush()
    assert len(Log.seen) == n
    for _ in range(8):
        srv.poll()
    assert Log.seen and set(Log.seen) == {0}
    for f in futs:
        r = f.result()
        np.testing.assert_array_equal(r.rows, p.oracle(r.query))


@pytest.mark.cuda
def test_failed_warm_up_is_kept_and_the_swap_lands(cuda, monkeypatch):
    """A warm-up launch made to fail fills ``warm_errors`` instead of
    raising; the swap still lands, and the next ``engine()`` builds."""
    from repro_torch.core import engine as teng
    from repro_torch.core.reopt import ReoptController
    from repro_torch.kernels import ops
    p, qs = _reopt_platform()
    ctl = ReoptController(p, session=p.session())
    gen = p.build_generation(theta=[0.03, 0.0, 0.0, 0.0])

    def fail(*a, **kw):
        raise RuntimeError("CUDA error: unspecified launch failure")
    monkeypatch.setattr(ops, "topk_l2_masked", fail)
    ctl._warm_generation(gen)
    monkeypatch.undo()
    assert ctl.warm_errors == [
        "RuntimeError: CUDA error: unspecified launch failure"]
    assert gen.engines == {} and ctl.status()["warm_errors"] == 1
    p.swap(gen)
    assert p._engines == {}
    built = []
    real_init = teng.HybridEngine.__init__
    monkeypatch.setattr(teng.HybridEngine, "__init__",
                        lambda self, *a, **kw: built.append(1)
                        or real_init(self, *a, **kw))
    got, _ = p.session().plan(qs).execute()
    assert built == [1]
    for q, g in zip(qs, got):
        np.testing.assert_array_equal(g, p.oracle(q))


def _flash_inputs(b, s, h, hd, dtype, cuda, seed=0, strided=False):
    rng = np.random.default_rng(seed)
    shape = (b, s, 2 * h if strided else h, hd)
    out = []
    for i in range(3):
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        t = t.to(cuda).to(dtype)
        out.append(t[:, :, ::2] if strided else t)   # strided heads
    return out


def assert_flash_close(got, q, k, v, causal, window):
    """fp32: within 2e-5 of the plain version; bf16: within one rounding
    to bf16 (2^-8 |b|) plus 2^-16 max|v| of the plain version's fp32
    result on the widened inputs."""
    if q.dtype == torch.float32:
        want = tref.flash_attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        return
    want = tref.flash_attention(q.float(), k.float(), v.float(),
                                causal=causal, window=window)
    tol = 2.0 ** -8 * want.abs() + 2.0 ** -16 * float(v.float().abs().max())
    err = (got.float() - want).abs()
    assert got.dtype == q.dtype
    assert bool((err <= tol).all()), float((err - tol).max())


# (route, type, head dims): each kernel at every head dim it takes
FLASH_ROUTES = [("simt", torch.float32, (16, 32, 64, 128)),
                ("simt", torch.bfloat16, (16, 32)),
                ("wgmma", torch.bfloat16, (64, 128))]


@pytest.mark.cuda
@pytest.mark.parametrize("route,dtype,hd", [
    (r, dt, hd) for r, dt, hds in FLASH_ROUTES for hd in hds])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0), (False, 40)])
def test_flash_kernel_matches_plain(cuda, route, dtype, hd, causal, window):
    """Each route at every head dim and type it takes, each mask, at
    S = 200 (not a multiple of the 64- or 128-row blocks: a ragged tail),
    with heads strided in memory (a view that skips every other head)."""
    assert flash_attention.route(dtype, hd) == route
    q, k, v = _flash_inputs(2, 200, 3, hd, dtype, cuda, seed=hd,
                            strided=True)
    before = flash_attention.launches
    by_route = dict(flash_attention.launches_by_route)
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window)
    assert flash_attention.launches == before + 1
    assert flash_attention.launches_by_route[route] == by_route[route] + 1
    assert got.shape == q.shape and got.is_contiguous()
    assert_flash_close(got, q, k, v, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("route,dtype,hd", [
    ("simt", torch.float32, 64), ("simt", torch.bfloat16, 32),
    ("wgmma", torch.bfloat16, 64), ("wgmma", torch.bfloat16, 128)])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 1000])
def test_flash_kernel_ragged_lengths(cuda, route, dtype, hd, s):
    assert flash_attention.route(dtype, hd) == route
    for causal, window in ((True, 0), (True, 100), (False, 0)):
        q, k, v = _flash_inputs(1, s, 4, hd, dtype, cuda, seed=s)
        got = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                                   window=window)
        assert_flash_close(got, q, k, v, causal, window)


# the SIMT kernel's edges: (B, S, H, hd), type, causal, window, inputs.
# Its query block is 128 at hd 64 / 128 and 64 at hd 16 / 32, its key
# tile 64: S below one block and S no multiple of either; windows whose
# edge falls inside a tile; "rows": views with rows hd + 4 elements apart
# and a base 4 elements in (the 4-element rule, read in place); bf16 at
# hd 16 and 32, widened on load; olmo-1b's prefill width.
SIMT_CASES = [
    ((1, 17, 3, 128), torch.float32, True, 0, "normal"),
    ((1, 100, 3, 128), torch.float32, False, 0, "normal"),
    ((2, 129, 2, 128), torch.float32, True, 0, "normal"),
    ((1, 191, 2, 64), torch.float32, True, 0, "normal"),
    ((1, 33, 3, 16), torch.float32, True, 0, "normal"),
    ((2, 191, 2, 16), torch.float32, False, 0, "normal"),
    ((1, 65, 2, 32), torch.float32, True, 0, "normal"),
    ((1, 300, 2, 128), torch.float32, True, 37, "normal"),
    ((1, 300, 2, 128), torch.float32, False, 100, "normal"),
    ((1, 300, 2, 16), torch.float32, True, 5, "normal"),
    ((1, 300, 2, 32), torch.float32, False, 70, "normal"),
    ((1, 300, 4, 128), torch.float32, True, 0, "rows"),
    ((1, 200, 4, 16), torch.float32, True, 24, "rows"),
    ((2, 300, 3, 16), torch.bfloat16, True, 0, "normal"),
    ((2, 300, 3, 32), torch.bfloat16, False, 40, "normal"),
    ((1, 100, 3, 32), torch.bfloat16, True, 0, "rows"),
    ((1, 2032, 16, 128), torch.float32, True, 0, "normal")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal,window,inputs", SIMT_CASES)
def test_flash_simt_kernel_edges(cuda, shape, dtype, causal, window,
                                 inputs):
    assert flash_attention.route(dtype, shape[3]) == "simt"
    b, s, h, hd = shape
    pad = 4 if inputs == "rows" else 0
    rng = np.random.default_rng(s + hd + window)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, s, h, hd + pad))
                                .astype(np.float32)).to(cuda).to(dtype)
               [..., pad:] for _ in range(3))
    before = flash_attention.launches_by_route["simt"]
    got = flash_attention.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window)
    assert flash_attention.launches_by_route["simt"] == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert_flash_close(got, q, k, v, causal, window)


@pytest.mark.cuda
def test_flash_simt_kernels_do_not_spill(cuda):
    """Every SIMT flash instantiation (fp32 and bf16 at hd 16, 32, 64 and
    128) compiles with no spill."""
    report = build.build_all()["flash_attention"]
    spills = {f: n for f, n in build.spill_bytes(report).items()
              if "flash_fwd" in f}
    assert len(spills) == 8 and not any(spills.values()), spills


@pytest.mark.cuda
def test_flash_routes_agree_at_the_prefill_width(cuda):
    """bf16 at hd 128, S = 300: the SIMT kernel, launched by name, and
    the wgmma kernel both hold the plain version's tolerance; a strided
    view whose strides are 4- but not 8-element aligned takes the
    explicit copy on the wgmma route."""
    q, k, v = _flash_inputs(1, 300, 4, 128, torch.bfloat16, cuda, seed=5)
    for kernel in ("simt", "wgmma"):
        got = flash_attention._launch(q, k, v, True, 0, kernel)
        assert_flash_close(got, q, k, v, True, 0)
    wide = [torch.zeros((1, 300, 4, 132), dtype=torch.bfloat16,
                        device=cuda) for _ in range(3)]
    for w, t in zip(wide, (q, k, v)):
        w[..., 4:].copy_(t)
    views = [w[..., 4:] for w in wide]     # strides 132: 4-, not 8-aligned
    got = flash_attention.flash_attention_cuda(*views)
    assert_flash_close(got, q, k, v, True, 0)


def _cancel_inputs(hd, cuda, s=64, h=2):
    """tests/test_torch_flash.py's split case: keys 0 and 1 share the
    weight (p = 1 and p = exp(-c 3.25 / 8), c near 1: neither normalised
    weight representable in bf16), every other key has weight 0, and
    their values in column 0 (1 and -1.5) nearly cancel."""
    c = 1.0 + 2.0 ** -7 * np.arange(-s // 2, s // 2)
    q = np.zeros((1, s, h, hd), np.float32)
    q[0, :, :, 0] = c[:, None]
    k = np.zeros((1, s, h, hd), np.float32)
    k[0, 0, :, 0] = 3.25 * np.sqrt(hd) / 8
    k[0, 2:, :, 0] = -1e4
    v = np.random.default_rng(hd).uniform(-1.5, 1.5, (1, s, h, hd))
    v = v.astype(np.float32)
    v[0, 0, :, 0], v[0, 1, :, 0] = 1.0, -1.5
    return [torch.from_numpy(x).to(cuda).bfloat16() for x in (q, k, v)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_wgmma_split_holds_where_values_cancel(cuda, hd):
    """Outputs near 0 where two keys' values cancel: one bf16 P would err
    there by up to 2^-8 p |v|, far above the bf16 tolerance; the wgmma
    kernel's P_hi + P_lo products must keep it."""
    q, k, v = _cancel_inputs(hd, cuda)
    want = tref.flash_attention(q.float(), k.float(), v.float(),
                                causal=False)
    assert int((want[..., 0].abs() < 0.01).sum()) >= 4
    before = flash_attention.launches_by_route["wgmma"]
    got = flash_attention.flash_attention_cuda(q, k, v, causal=False)
    assert flash_attention.launches_by_route["wgmma"] == before + 1
    assert_flash_close(got, q, k, v, False, 0)


@pytest.mark.cuda
def test_flash_kernel_rejects_bad_inputs(cuda):
    q, k, v = _flash_inputs(1, 8, 2, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention_cuda(q[..., :48], k[..., :48],
                                             v[..., :48])
    with pytest.raises(ValueError, match="must match q"):
        flash_attention.flash_attention_cuda(q, k[:, :4], v[:, :4])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="no 'wgmma' kernel"):
        flash_attention._launch(q, k, v, True, 0, "wgmma")


@pytest.mark.cuda
def test_serve_engine_generates_on_card(cuda):
    """Reduced llama3-8b at fp32 on the card: the prefill goes through the
    flash kernel, batched generation over mixed lengths equals
    per-request generation, and the tokens equal the CPU's for the same
    weights."""
    from dataclasses import replace
    cfg = replace(get_config("llama3-8b").reduced(), dtype="float32")
    eng = ServeEngine(cfg, device=cuda, max_len=64, batch_size=4, seed=0)
    cpu = ServeEngine(cfg, params_from_numpy(
        cfg, params_to_numpy(cfg, eng.params), "cpu"), device="cpu",
        max_len=64, batch_size=4)
    rng = np.random.default_rng(7)
    reqs = [GenRequest(rng.integers(1, 200, size=n).astype(np.int32), 6)
            for n in (5, 40, 7, 40)]
    before = flash_attention.launches
    batched = eng.generate(reqs)
    assert flash_attention.launches > before
    on_cpu = cpu.generate(reqs)
    for i, r in enumerate(reqs):
        solo = eng.generate([r])[0]
        np.testing.assert_array_equal(batched[i].tokens, solo.tokens)
        np.testing.assert_array_equal(batched[i].tokens, on_cpu[i].tokens)


@pytest.mark.cuda
def test_flash_wgmma_window_1024_at_hd_64(cuda):
    """hymba's attention on the card: bf16 at hd 64 (the wgmma route)
    with its 1024-position window, at 2048 positions (every query past
    1024 loses keys to the window), and its global layers (no window), to
    the plain version."""
    assert flash_attention.route(torch.bfloat16, 64) == "wgmma"
    q, k, v = _flash_inputs(2, 2048, 4, 64, torch.bfloat16, cuda, seed=3)
    for window in (1024, 0):
        before = flash_attention.launches_by_route["wgmma"]
        got = flash_attention.flash_attention_cuda(q, k, v, causal=True,
                                                   window=window)
        assert flash_attention.launches_by_route["wgmma"] == before + 1
        assert_flash_close(got, q, k, v, True, window)


def _chip_smoke():
    """The repository root's ``chip_smoke`` module (its plain-torch
    one-hot MoE is the formulation both sides hold ``moe`` to)."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["phi3.5-moe-42b-a6.6b", "arctic-480b"])
def test_moe_index_dispatch_matches_onehot_on_card(cuda, name):
    """``moe``'s index dispatch (gather, batched expert products,
    ``index_add_``) against the reference's one-hot formulation in plain
    torch on the card, bf16, 16 experts at d_model 256: the same routing
    (experts, slots, kept) and outputs within 2^-8 of the output's largest
    magnitude (the expert products' GEMMs may be chosen otherwise for the
    two layouts); repeated tokens force drops."""
    from dataclasses import replace
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    cfg = replace(get_config(name).reduced(), d_model=256, num_experts=16,
                  moe_ff=512, num_layers=1)
    p = build_model(cfg, cuda).init(0).blocks[0].moe
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, 300, 256)).astype(np.float32)).to(cuda).bfloat16()
    x[:, 200:] = x[:, 199:200]        # one token 100 times: drops
    got, _ = moe_mod.moe(cfg, p, x)
    r = moe_mod.route(cfg, p, x)
    want, ti, slot, keep = _chip_smoke().moe_onehot(torch, cfg, p, x)
    assert not bool(keep.all())
    assert torch.equal(r.topk_i, ti) and torch.equal(r.slot, slot)
    assert torch.equal(r.keep, keep)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2.0 ** -8 * float(want.float().abs().max())


@pytest.mark.cuda
def test_hymba_graphed_decode_equals_eager_steps(cuda):
    """hymba's decode on the card: the cache's first step captures the
    step as a CUDA graph and every later one replays it; 40 steps (the
    16-slot ring wraps twice) give the same logits and cache bits as the
    same steps run eagerly on another cache, and the tokens of a batch
    equal those of each request alone."""
    from dataclasses import replace
    from repro_torch.models import build_model
    from repro_torch.models import hymba
    cfg = get_config("hymba-1.5b").reduced()
    m = build_model(cfg, cuda)
    p = m.init(0)
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda)
    graphed, eager = m.init_cache(2, 48), m.init_cache(2, 48)
    for t in range(40):
        lg, graphed = m.decode(p, graphed, toks[:, t:t + 1])
        want = hymba._step(cfg, p, eager, toks[:, t:t + 1],
                           torch.tensor(t, device=cuda))
        eager = replace(eager, length=t + 1)
        assert torch.equal(lg, want), t
    assert graphed.graph is not None and graphed.length == 40
    for name in ("wk", "wv", "wpos", "gk", "gv", "w_ssm", "g_ssm"):
        assert torch.equal(getattr(graphed, name), getattr(eager, name))
    eng = ServeEngine(cfg, p, device=cuda, max_len=48, batch_size=2)
    reqs = [GenRequest(toks[i].cpu().numpy().astype(np.int32), 5)
            for i in range(2)]
    batched = eng.generate(reqs)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(batched[i].tokens,
                                      eng.generate([r])[0].tokens)


def _carry(cfg, params):
    """The same parameters on the CPU."""
    return params_from_numpy(cfg, params_to_numpy(cfg, params), "cpu")


def _close_to(got, want, tol, msg=""):
    got, want = got.float().cpu(), want.float().cpu()
    assert got.shape == want.shape, msg
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (msg, err)


@pytest.mark.cuda
def test_xlstm_on_card_matches_cpu(cuda):
    """Reduced xlstm with sLSTM blocks (4 layers, two groups of 1 mLSTM +
    1 sLSTM) at fp32 on the card against the CPU port on the same weights
    and tokens, within 1e-4 of the largest magnitude (sum order): the
    forward, the prefill's state array for array and 4 decode steps;
    ``ServeEngine``'s tokens equal the CPU's; the sLSTM scan's captured
    step (``_scan_graphed``) and the graphed decode step equal the same
    steps launched one by one bit for bit."""
    from dataclasses import replace
    from repro_torch.models import build_model
    from repro_torch.models import xlstm
    cfg = replace(get_config("xlstm-1.3b").reduced(), num_layers=4,
                  slstm_every=2, dtype="float32")
    m, mc = build_model(cfg, cuda), build_model(cfg, "cpu")
    p = m.init(0)
    pc = _carry(cfg, p)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 32))
    _close_to(m.forward(p, {"tokens": toks})[0],
              mc.forward(pc, {"tokens": toks})[0], 1e-4, "forward")
    lg, st = m.prefill(p, {"tokens": toks}, 40)
    lc, sc = mc.prefill(pc, {"tokens": toks}, 40)
    _close_to(lg, lc, 1e-4, "prefill")
    names = ("mc", "mn", "mm", "sc", "sn", "sm", "sh")
    for name in names:
        _close_to(getattr(st, name), getattr(sc, name), 1e-4, name)
    eager = replace(st, **{n: getattr(st, n).clone() for n in names})
    step_toks = torch.from_numpy(toks).to(cuda)
    for t in range(4):
        lg, st = m.decode(p, st, toks[:, t:t + 1])
        lc, sc = mc.decode(pc, sc, toks[:, t:t + 1])
        _close_to(lg, lc, 1e-4, f"step {t}")
        # the captured step replays exactly what the step launches
        assert torch.equal(lg, xlstm._step(cfg, p, eager,
                                           step_toks[:, t:t + 1])), t
    assert st.graph is not None
    assert all(torch.equal(getattr(st, n), getattr(eager, n))
               for n in names)
    sp = p.slstm[1]
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(2, 24, cfg.d_model)).astype(np.float32)).to(cuda)
    wx = (x @ sp.wx.reshape(cfg.d_model, -1)).view(2, 24, 4, 4, 16) + sp.b
    r = sp.r.transpose(0, 1).reshape(4, 64, 16)
    zero = xlstm.slstm_zero_state(2, 4, 16, cuda)
    ys_g, st_g = xlstm._scan_graphed(r, wx, zero)
    ys_e, st_e = xlstm._scan_eager(r, wx, zero)
    assert torch.equal(ys_g, ys_e)
    assert all(torch.equal(a, b) for a, b in zip(st_g, st_e))
    reqs = [GenRequest(toks[i, :n].astype(np.int32), 5)
            for i, n in ((0, 16), (1, 32), (1, 16))]
    on_card = ServeEngine(cfg, p, device=cuda, max_len=40,
                          batch_size=2).generate(reqs)
    on_cpu = ServeEngine(cfg, pc, device="cpu", max_len=40,
                         batch_size=2).generate(reqs)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.cuda
def test_encdec_on_card_matches_cpu(cuda):
    """Reduced seamless-m4t-medium (2 + 2 layers, Gaussian frames) at fp32
    on the card against the CPU port on the same weights and inputs,
    within 1e-4 of the largest magnitude: the forward in both modes (the
    stream one through the SIMT flash kernel at hd 16), the cross cache,
    the prompt's replay through the graphed decode step and 2 steps
    more; ``ServeEngine``'s tokens (zero frames) equal the CPU's."""
    from dataclasses import replace
    from repro_torch.models import build_model
    cfg = replace(get_config("seamless-m4t-medium").reduced(),
                  dtype="float32")
    m, mc = build_model(cfg, cuda), build_model(cfg, "cpu")
    p = m.init(0)
    pc = _carry(cfg, p)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 20)),
             "frames": rng.normal(size=(2, cfg.frontend_tokens,
                                        cfg.d_model)).astype(np.float32)}
    for mode in ("train", "stream"):
        before = flash_attention.launches_by_route["simt"]
        _close_to(m.forward(p, batch, mode=mode)[0],
                  mc.forward(pc, batch, mode=mode)[0], 1e-4, mode)
        assert flash_attention.launches_by_route["simt"] - before == \
            (cfg.num_layers if mode == "stream" else 0)
    lg, cache = m.prefill(p, batch, 24)
    lc, ccache = mc.prefill(pc, batch, 24)
    _close_to(lg, lc, 1e-4, "prefill")
    _close_to(cache.xk, ccache.xk, 1e-4, "xk")
    toks = np.concatenate([batch["tokens"], batch["tokens"][:, :2]], 1)
    for t in range(22):
        lg, cache = m.decode(p, cache, toks[:, t:t + 1])
        lc, ccache = mc.decode(pc, ccache, toks[:, t:t + 1])
        _close_to(lg, lc, 1e-4, f"step {t}")
    assert cache.graph is not None and cache.length == 22
    _close_to(cache.k, ccache.k, 1e-4, "k")
    reqs = [GenRequest(batch["tokens"][i, :n].astype(np.int32), 4)
            for i, n in ((0, 7), (1, 12), (1, 7))]
    on_card = ServeEngine(cfg, p, device=cuda, max_len=24,
                          batch_size=2).generate(reqs)
    on_cpu = ServeEngine(cfg, pc, device="cpu", max_len=24,
                         batch_size=2).generate(reqs)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_array_equal(a.tokens, b.tokens)


@pytest.mark.cuda
def test_encdec_stream_prefill_takes_wgmma_and_is_held(cuda):
    """The enc-dec prefill's stream forward at seamless-m4t-medium's head
    shape (bf16, hd 64), narrowed to 4 heads, 128 frames: every decoder
    layer launches the wgmma kernel once, each launch held to the plain
    version (``chip_smoke.held_flash``), and nothing else launches a
    flash kernel (the encoder and the cross-attention are dense)."""
    from dataclasses import replace
    cs = _chip_smoke()
    cfg = replace(get_config("seamless-m4t-medium").reduced(), d_model=256,
                  num_heads=4, num_kv_heads=4, head_dim=64,
                  frontend_tokens=128)
    eng = ServeEngine(cfg, device=cuda, max_len=80, batch_size=2, seed=0)
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab_size, (2, 64))
    before = dict(flash_attention.launches_by_route)
    with cs.held_flash(torch, flash_attention, tref, "wgmma",
                       True) as checks:
        lg, cache = eng.model.prefill(eng.params, {
            "tokens": toks, "frames": rng.normal(size=(
                2, 128, 256)).astype(np.float32)}, 80)
    assert bool(lg.isfinite().all()) and cache.length == 0
    assert len(checks) == cfg.num_layers
    assert all(c[2] and c[5] for c in checks), checks
    assert {c[0] for c in checks} == {(2, 64, 4, 64)}
    assert flash_attention.launches_by_route == {
        "wgmma": before["wgmma"] + cfg.num_layers, "simt": before["simt"]}


# ------------------------------------------------------------ training
def _train_cfg(dtype="float32"):
    import dataclasses
    return dataclasses.replace(get_config("mqrld-embedder-100m").reduced(),
                               dtype=dtype)


def _train_batch(cfg, rows=4, seq=16, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (rows, seq)).astype(np.int32)
            for k in ("tokens", "labels")}


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One fp32 step's loss and gradient (two microbatches) on the card
    against the CPU's from the same masters: the loss within 1e-5
    relative, each gradient leaf within 1e-4 of its largest magnitude
    (sum order); then a train step on the card gives that loss, a finite
    update and the count 1. (Updated masters are not compared: AdamW's
    first step is the sign of each gradient entry, which flips where an
    entry is at rounding level; the law itself is
    ``test_adamw_on_card_bit_for_bit``.)"""
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.step import loss_and_grads, make_train_step
    cfg = _train_cfg()
    host = build_model(cfg, "cpu").init_masters(0)
    batch = _train_batch(cfg)
    want_l, want_g = loss_and_grads(build_model(cfg, "cpu"), host, batch, 2)
    model = build_model(cfg, cuda)
    params = {k: t.to(cuda) for k, t in host.items()}
    got_l, got_g = loss_and_grads(model, params, batch, 2)
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    for k, g in want_g.items():
        assert got_g[k].is_cuda and got_g[k].dtype == torch.float32
        assert float((got_g[k].cpu() - g).abs().max()) <= \
            1e-4 * float(g.abs().max()), k
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, microbatches=2)
    new_p, opt, met = make_train_step(model, tc)(params, init_adam(params),
                                                 batch)
    assert abs(float(met["loss"]) - float(want_l)) <= \
        1e-5 * abs(float(want_l))
    assert int(met["step"]) == 1 and int(opt.count) == 1
    assert all(bool(torch.isfinite(t).all()) for t in new_p.values())


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_on_card_bit_for_bit(cuda, state_dtype):
    """Two AdamW updates on the card equal the same updates on the CPU
    from the same masters, state and gradients, bit for bit, given the
    card's global norm (the norms themselves within 1e-6 relative)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as O
    cfg = _train_cfg()
    tc = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=10)
    host = build_model(cfg, "cpu").init_masters(1)
    gen = torch.Generator().manual_seed(2)
    grads = [{k: torch.randn(t.shape, generator=gen) * 0.05
              for k, t in host.items()} for _ in range(2)]
    card = ({k: t.to(cuda) for k, t in host.items()}, None)
    card = (card[0], O.init_adam(card[0], state_dtype))
    cpu = (host, O.init_adam(host, state_dtype))
    for g in grads:
        p, s, n = O.adam_update(tc, card[0], {k: t.to(cuda) for k, t in
                                              g.items()}, card[1],
                                state_dtype)
        hp, hs, hn = O.adam_update(tc, cpu[0], g, cpu[1], state_dtype,
                                   gnorm=n.cpu())
        assert abs(float(n) - float(O.global_norm(g))) <= \
            1e-6 * float(O.global_norm(g))
        card, cpu = (p, s), (hp, hs)
    for k, t in card[0].items():
        assert torch.equal(t.cpu(), cpu[0][k]), k
    for name in ("m", "v"):
        for k, enc in getattr(card[1], name).items():
            want = getattr(cpu[1], name)[k]
            got = enc if isinstance(enc, tuple) else (enc,)
            want = want if isinstance(want, tuple) else (want,)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a.cpu(), b), k
    assert int(card[1].count) == 2


@pytest.mark.cuda
def test_int8_state_train_on_card_finite(cuda, tmp_path):
    """``train()`` on the card (its default device) in int8 state: three
    steps, finite losses and masters, m and v int8 codes with (..., 1)
    scales wherever the stacked shape has rank >= 2."""
    from repro_torch.configs import TrainConfig
    from repro_torch.train.loop import train
    cfg = _train_cfg("bfloat16")
    tc = TrainConfig(total_steps=3, warmup_steps=1, checkpoint_every=0,
                     checkpoint_dir=str(tmp_path))
    res = train(cfg, tc, seq_len=16, state_dtype="int8",
                log_fn=lambda s: None)
    assert res.steps_run == 3 and np.isfinite(res.losses).all()
    for k, p in res.params.items():
        assert p.is_cuda and bool(torch.isfinite(p).all())
        if p.dim() >= 2:
            for enc in (res.opt.m[k], res.opt.v[k]):
                assert enc[0].dtype == torch.int8
                assert tuple(enc[1].shape) == tuple(p.shape[:-1]) + (1,)


# ------------------------------------------- training the other families
FAMILY_TRAIN = {"hymba-1.5b": {}, "xlstm-1.3b": dict(num_layers=4,
                                                     slstm_every=2),
                "seamless-m4t-medium": {}}


def _family_case(name, seed=0, rows=4, seq=16):
    """Reduced ``name`` in fp32, its masters with q and k tempered to the
    d_model fan-in (at the init law the gradient is ill-conditioned:
    ``tests/test_torch_train_families.py``) and a batch (with frames for
    enc-dec)."""
    import dataclasses
    import math
    from repro_torch.configs import ShapeConfig
    from repro_torch.models import build_model
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32",
                              **FAMILY_TRAIN[name])
    m = build_model(cfg, "cpu")
    masters = {k: t * math.sqrt(t.shape[-2] / t.shape[-3])
               if k.rsplit("/", 1)[-1] in ("wq", "wk") else t
               for k, t in m.init_masters(seed).items()}
    batch = {k: v.numpy() for k, v in m.make_batch(
        ShapeConfig("t", seq, rows, "train"), seed + 1).items()}
    return cfg, masters, batch


@pytest.mark.cuda
def test_slstm_scan_graphed_on_card(cuda, monkeypatch):
    """``SLSTMScan`` on the card: graphed (forward and reverse steps each
    one captured CUDA graph) against the same Function step by step,
    outputs and gradients bit for bit; against the CPU's within 1e-5 of
    each tensor's largest magnitude (fp32 sum order); and a loss taken
    with gradients on a CUDA tensor runs its sLSTM blocks through the
    graphed Function."""
    from repro_torch.models import build_model
    from repro_torch.models import xlstm
    gen = torch.Generator().manual_seed(3)
    b, s, h, hd = 3, 40, 4, 16
    r = torch.randn(h, 4 * hd, hd, generator=gen) * 0.3
    wx = torch.randn(b, s, 4, h, hd, generator=gen)
    cot = [torch.randn(b, s, h, hd, generator=gen)] + \
        [torch.randn(b, h, hd, generator=gen) for _ in range(4)]
    out = {}
    for where, graphed in (("graphed", True), ("steps", False),
                           ("cpu", False)):
        dev = torch.device("cpu") if where == "cpu" else cuda
        ri = r.to(dev).requires_grad_(True)
        wi = wx.to(dev).requires_grad_(True)
        st = xlstm.slstm_zero_state(b, h, hd, dev)
        res = xlstm.SLSTMScan.apply(ri, wi, *st, graphed)
        loss = sum((o * c.to(dev)).sum() for o, c in zip(res, cot))
        grads = torch.autograd.grad(loss, (ri, wi))
        out[where] = [t.detach().cpu() for t in (*res, *grads)]
    for a, c, g in zip(out["graphed"], out["steps"], out["cpu"]):
        assert torch.equal(a, c)
        assert float((a - g).abs().max()) <= 1e-5 * float(g.abs().max())
    cfg, masters, batch = _family_case("xlstm-1.3b")
    taken = []
    real = xlstm.SLSTMScan.apply
    monkeypatch.setattr(xlstm.SLSTMScan, "apply", lambda *a: (
        taken.append(a[-1]), real(*a))[1])
    model = build_model(cfg, cuda)
    p_c = {k: t.to(cuda).requires_grad_(True) for k, t in masters.items()}
    model.loss(p_c, batch).backward()
    assert taken == [True, True]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FAMILY_TRAIN))
def test_family_train_step_on_card_matches_cpu(cuda, name):
    """Reduced hymba, xlstm (with sLSTM blocks) and enc-dec: one fp32
    step's loss and gradient (two microbatches) on the card against the
    CPU's from the same masters, the loss within 1e-5 relative and each
    leaf within 1e-4 of its largest magnitude (sum order); then a train
    step on the card: that loss, finite masters, the count 1."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.step import loss_and_grads, make_train_step
    cfg, masters, batch = _family_case(name)
    want_l, want_g = loss_and_grads(build_model(cfg, "cpu"), masters,
                                    batch, 2)
    model = build_model(cfg, cuda)
    params = {k: t.to(cuda) for k, t in masters.items()}
    got_l, got_g = loss_and_grads(model, params, batch, 2)
    assert abs(float(got_l) - float(want_l)) <= 1e-5 * abs(float(want_l))
    for k, g in want_g.items():
        assert got_g[k].is_cuda and got_g[k].dtype == torch.float32
        assert float((got_g[k].cpu() - g).abs().max()) <= \
            1e-4 * float(g.abs().max()), k
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, microbatches=2)
    new_p, opt, met = make_train_step(model, tc)(params, init_adam(params),
                                                 batch)
    assert abs(float(met["loss"]) - float(want_l)) <= \
        1e-5 * abs(float(want_l))
    assert int(opt.count) == 1
    assert all(bool(torch.isfinite(t).all()) for t in new_p.values())


@pytest.mark.cuda
def test_compressed_step_on_card(cuda):
    """``make_compressed_train_step`` over ``pod_mesh(2)`` on the card: the
    loss within 0.05 of the plain step's on the same batch and every
    parameter within 1e-2 (the reference's bounds); ``pod_sync`` of
    gradients on the card equals the CPU's on the same values bit for
    bit (codes, scales and the decode are exact or single roundings)."""
    from repro_torch.configs import TrainConfig
    from repro_torch.models import build_model
    from repro_torch.sharding import pod_mesh
    from repro_torch.train import compression as C
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.step import make_train_step
    cfg = _train_cfg()
    model = build_model(cfg, cuda)
    masters = {k: t.to(cuda) for k, t in
               build_model(cfg, "cpu").init_masters(0).items()}
    batch = _train_batch(cfg, rows=16, seq=8, seed=2)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1)
    mesh = pod_mesh(2, cuda)
    opt = init_adam(masters)
    p1, _, m1 = make_train_step(model, tc)(masters, opt, batch)
    p2, o2, e2, m2 = C.make_compressed_train_step(model, tc, mesh)(
        masters, opt, C.init_error_tree(masters, mesh), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 0.05
    assert max(float((p1[k] - p2[k]).abs().max()) for k in p1) < 1e-2
    assert all(e.is_cuda and e.shape[0] == 2 for e in e2.values())
    gen = torch.Generator().manual_seed(4)
    g = torch.randn(2, 6, 40, generator=gen) * 0.05
    e = torch.randn(2, 6, 40, generator=gen) * 1e-3
    want = C.pod_sync(pod_mesh(2, "cpu"), g, e)
    got = C.pod_sync(mesh, g.to(cuda), e.to(cuda))
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["reduced", "full"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_xlstm_rows_independent_on_card(cuda, width, dtype):
    """xlstm's forward on the card (no gradients: the chunked mLSTM and
    the graphed sLSTM scan) gives each row the same logits in a batch of
    4 as in batches of 2 and of 1, within 1e-10 (fp64) or 1e-4 (fp32)
    of the largest magnitude; and the same with gradients enabled (the
    graphed ``SLSTMScan``). ``full``: xlstm-1.3b's width (d_model 2048, 4
    heads of hd 512) at 2 layers (1 mLSTM + 1 sLSTM), vocab 256."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.models import xlstm
    base = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(base.reduced(), num_layers=4, slstm_every=2) \
        if width == "reduced" else dataclasses.replace(
            base, num_layers=2, slstm_every=2, vocab_size=256)
    cfg = dataclasses.replace(cfg, dtype=dtype)
    masters = build_model(cfg, cuda).init_masters(0)
    dt = getattr(torch, dtype)
    views = xlstm.stacked_views(cfg, {k: t.to(dt) for k, t in
                                      masters.items()})
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 64))).to(cuda)
    tol = 1e-10 if dtype == "float64" else 1e-4
    for grad in (False, True):
        with torch.set_grad_enabled(grad):
            if grad:
                views = xlstm.stacked_views(cfg, {
                    k: t.to(dt).requires_grad_(True)
                    for k, t in masters.items()})
            whole = xlstm.forward(cfg, views, toks)[0].detach()
            for size in (2, 1):
                for i in range(0, 4, size):
                    part = xlstm.forward(cfg, views, toks[i:i + size])[0]
                    _close_to(part.detach(), whole[i:i + size], tol,
                              (grad, size, i))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_counter_live_on_card_equals_fake_trace(cuda, kind):
    """The op counter run live on the card's tensors gives the fake CPU
    trace's FLOPs and kernel charges exactly (reduced llama3-8b; the
    prefill's attention charged as the flash kernel on both)."""
    import dataclasses
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.utils import opcount
    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              head_dim=64, d_model=128, num_heads=2,
                              num_kv_heads=1)
    shape = ShapeConfig(kind, 256, 4, kind)
    over = dryrun.overrides("llama3-8b", kind)
    fake, _ = dryrun.trace(dryrun.program(cfg, shape, make_dev_mesh(1, 1),
                                          over))
    prog = dryrun.program(cfg, shape, make_dev_mesh(1, 1), over,
                          device=cuda)
    args = dryrun.make_args(prog, seed=0)
    with opcount.count_ops(fake=False) as c:
        c.run(prog.step, *args)
        torch.cuda.synchronize()
    assert c.stats.flops == fake.flops > 0
    assert c.stats.kernels == fake.kernels
    assert ("flash_attention" in c.stats.kernels) == (kind == "prefill")


@pytest.mark.cuda
def test_hibog_kernel_route_equals_plain_route(cuda):
    """HIBOG on the card (``topk_l2`` kernel, one launch an iteration at
    least) returns the CPU's plain route's moved points within 1e-5 of
    their largest magnitude, on points where every distance is exact."""
    from repro_torch.core.lpgf import hibog
    from repro_torch.kernels import fused_topk
    rng = np.random.default_rng(3)
    x = np.unique(rng.integers(-12, 13, (1200, 8)), axis=0)[:600]
    x = (x[rng.permutation(len(x))] * 0.25).astype(np.float32)
    fused_topk.reset_launches()
    got = hibog(x, k=8, iters=2, device=cuda)
    assert fused_topk.topk_l2_launches >= 2
    want = hibog(x, k=8, iters=2, device="cpu")
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
