"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test is marked ``cuda`` and skips where there is no CUDA
device (a CUDA kernel has no CPU mode). This file imports neither JAX nor
the reference package, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: ids exact; squared distances rtol=1e-5, atol=1e-5 at these
small widths (fp32 summation order differs between the kernel and the
library GEMM), and exactly equal on integer-grid inputs, where every sum
is exact in fp32.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import query as Q
from repro_torch.core.lake import MMOTable
from repro_torch.core.platform import MQRLD
from repro_torch.kernels import fused_topk, pairwise_l2
from repro_torch.kernels import ref as tref

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
                                  "ragged", "k256"])
@pytest.mark.parametrize("with_lb2", [False, True])
def test_topk_masked_kernel_matches_plain(cuda, kind, with_lb2):
    q, p, v, k = _masked_case(kind)
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
def test_topk_masked_rejects_large_k(cuda):
    q = torch.zeros((1, 4), device=cuda)
    p = torch.zeros((1, 300, 4), device=cuda)
    v = torch.ones((1, 300), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="k <= 256"):
        fused_topk.topk_l2_masked_cuda(q, p, v, 257)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 17, 256])
def test_topk_l2_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(0)
    p = torch.from_numpy(
        rng.integers(-3, 4, (5000, 24)).astype(np.float32)).to(cuda)
    q = p[torch.arange(0, 5000, 50, device=cuda)].contiguous()
    gd, gi = fused_topk.topk_l2_cuda(q, p, k)
    wd, wi = tref.topk_l2(q, p, k)
    assert torch.equal(gi, wi)
    assert torch.equal(gd, wd)


@pytest.fixture(scope="module")
def card_platform():
    """A small platform prepared on the card (N above LPGF's 4096-point
    force-kernel branch, whose kernel is not ported yet)."""
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
@pytest.mark.parametrize("k", [20, 250, 256])
def test_engine_rows_equal_oracle_on_card(card_platform, k):
    """Up to the kernels' k limit, both beam loops on the card return the
    oracle's rows."""
    p = card_platform
    tab = p.table.vector["v"]
    qs = [Q.VK.of("v", tab[i], k) for i in (0, 1234, 4321)]
    qs.append(Q.And.of(Q.NR("price", 25, 75), Q.VK.of("v", tab[7], k)))
    for device_loop in (True, False):
        got, _ = p.session().plan(qs, device_loop=device_loop).execute()
        for q, g in zip(qs, got):
            np.testing.assert_array_equal(g, p.oracle(q))
