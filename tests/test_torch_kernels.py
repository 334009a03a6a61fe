"""The port's kernels: plain PyTorch versions against the JAX package's
functions on the CPU (Pallas kernels in interpret mode, as
tests/test_kernels.py runs them), and the CPU dispatch of the wrappers.
The CUDA kernels themselves are held to these plain versions on the card
by tests/test_torch_cuda.py and chip_smoke.py.

Tolerance: ids exact. Squared distances rtol=1e-5, atol=1e-5, because
the fp32 quadratic expansion is summed in another order by XLA than by
torch's CPU GEMM.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_topk import topk_l2_masked_pallas, topk_l2_pallas
from repro.kernels.lpgf_force import lpgf_force_pallas
from repro.kernels.pairwise_l2 import pairwise_sq_l2_pallas
from repro_torch.kernels import fused_topk, lpgf_force, ops, pairwise_l2
from repro_torch.kernels import quant_lb2
from repro_torch.kernels import ref as tref
from repro_torch.utils.quant import plan_tiles

torch.set_num_threads(1)

RTOL = ATOL = 1e-5   # fp32 summation order (XLA vs torch CPU GEMM)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape)
            * scale).astype(np.float32)


def _masked_case(kind, seed=0):
    """(q, p, valid, k) for one edge case of the masked top-k sweep."""
    rng = np.random.default_rng(seed)
    g, c, d, k = 6, 70, 8, 9
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
    elif kind == "duplicates":
        half = _np((g, c // 2, d), seed + 2)
        p = np.concatenate([half, half], axis=1)    # every point twice
        valid = np.ones((g, c // 2 * 2), bool)
    elif kind == "ties":
        # integer grid: every distance exact in fp32, many exact ties
        q = rng.integers(-2, 3, (g, d)).astype(np.float32)
        p = rng.integers(-2, 3, (g, c, d)).astype(np.float32)
    elif kind == "ragged":
        c = 37
        p = p[:, :c]
        valid = valid[:, :c]
    return q, p, valid, k


CASES = ["plain", "all_masked", "k_gt_c", "duplicates", "ties", "ragged"]


@pytest.mark.parametrize("kind", CASES)
def test_topk_masked_plain_matches_pallas(kind):
    q, p, v, k = _masked_case(kind)
    wd, wi = topk_l2_masked_pallas(jnp.asarray(q), jnp.asarray(p),
                                   jnp.asarray(v), k, interpret=True)
    gd, gi = tref.topk_l2_masked(torch.from_numpy(q), torch.from_numpy(p),
                                 torch.from_numpy(v), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("lb", ["zero", "half", "inf_pad"])
def test_topk_masked_lb2_never_changes_ids(lb):
    """The lb2 hint (0, a legal ball-style bound, +inf on masked columns)
    leaves the ids of the Pallas kernel and of the plain version equal."""
    q, p, v, k = _masked_case("plain", seed=3)
    dtrue = ((p - q[:, None, :]) ** 2).sum(-1).astype(np.float32)
    lb2 = {"zero": np.zeros_like(dtrue), "half": 0.5 * dtrue,
           "inf_pad": np.where(v, 0.0, np.inf).astype(np.float32)}[lb]
    wd, wi = topk_l2_masked_pallas(jnp.asarray(q), jnp.asarray(p),
                                   jnp.asarray(v), k, interpret=True,
                                   lb2=jnp.asarray(lb2))
    gd, gi = ops.topk_l2_masked(torch.from_numpy(q), torch.from_numpy(p),
                                torch.from_numpy(v), k,
                                lb2=torch.from_numpy(lb2))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("m,n,d,k", [(20, 100, 8, 5), (7, 500, 16, 1),
                                     (50, 33, 4, 33), (9, 64, 3, 2),
                                     (6, 400, 5, 300)])
def test_topk_l2_plain_matches_pallas(m, n, d, k):
    q, p = _np((m, d), m), _np((n, d), n)
    if d == 3:   # integer grid: exact distances with ties
        q, p = np.round(q * 2), np.round(p * 2)
    wd, wi = topk_l2_pallas(jnp.asarray(q), jnp.asarray(p), k,
                            interpret=True)
    gd, gi = ops.topk_l2(torch.from_numpy(q), torch.from_numpy(p), k)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=RTOL,
                               atol=ATOL)
    bd, bi = ops.topk_l2_blocked(torch.from_numpy(q), torch.from_numpy(p),
                                 k, row_block=4)
    np.testing.assert_array_equal(bi.numpy(), gi.numpy())


@pytest.mark.parametrize("m,n,d", [(17, 33, 5), (64, 64, 16), (1, 300, 12),
                                   (130, 1, 7)])
def test_pairwise_plain_matches_pallas_and_ref(m, n, d):
    q, p = _np((m, d), m), _np((n, d), n)
    want = np.asarray(jref.pairwise_sq_l2(jnp.asarray(q), jnp.asarray(p)))
    pal = np.asarray(pairwise_sq_l2_pallas(jnp.asarray(q), jnp.asarray(p),
                                           bm=32, bn=64, interpret=True))
    got = ops.pairwise_sq_l2(torch.from_numpy(q), torch.from_numpy(p))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), pal, rtol=RTOL, atol=ATOL)
    blk = ops.pairwise_sq_l2_blocked(torch.from_numpy(q),
                                     torch.from_numpy(p), row_block=16)
    np.testing.assert_allclose(blk.numpy(), got.numpy(), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n,d", [(90, 11), (200, 5), (33, 2)])
@pytest.mark.parametrize("r,g", [(2.5, 0.7), (10.0, 1.5)])
def test_lpgf_force_plain_matches_pallas(n, d, r, g):
    """The plain version against the TPU kernel in interpret mode, over
    tests/test_kernels.py's sweep: both exclude self pairs by index, so F
    and W agree within the fp32 sum order (F relative to its largest
    entry). At r = 10 the radius covers max(d2) + 1, where the
    reference's plain version would count each point's own pair in W."""
    x = _np((n, d), n * d)
    wf, ww = lpgf_force_pallas(jnp.asarray(x), r, g, bm=32, bn=32,
                               interpret=True)
    gf, gw = ops.lpgf_force(torch.from_numpy(x), r, g)
    scale = float(np.abs(np.asarray(wf)).max()) + 1e-6
    np.testing.assert_allclose(gf.numpy() / scale, np.asarray(wf) / scale,
                               atol=2e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=1e-4,
                               atol=1e-4)


def test_lpgf_force_plain_matches_ref():
    x = _np((60, 6), 5)
    wf, ww = jref.lpgf_force(jnp.asarray(x), 3.0, 1.5)
    gf, gw = ops.lpgf_force(torch.from_numpy(x), 3.0, 1.5)
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=RTOL,
                               atol=ATOL)


def test_stable_topk_tie_law():
    """Equal values order by the lower column; -0.0 counts as 0."""
    d = torch.tensor([[3.0, 1.0, 1.0, float("inf"), 0.0, -0.0, 1.0]])
    v, i = tref.stable_topk(d, 6)
    assert i.tolist() == [[4, 5, 1, 2, 6, 0]]
    assert v.tolist() == [[0.0, 0.0, 1.0, 1.0, 1.0, 3.0]]


def test_wrappers_take_plain_version_on_cpu():
    """A CPU tensor never reaches a kernel: no launch is counted and the
    result is the plain version's."""
    q, p, v, k = _masked_case("plain")
    before = (pairwise_l2.launches, fused_topk.topk_l2_launches,
              fused_topk.topk_l2_masked_launches, quant_lb2.launches,
              lpgf_force.launches)
    qt, pt = torch.from_numpy(q), torch.from_numpy(p)
    pairwise_l2.pairwise_sq_l2(qt, pt[0])
    fused_topk.topk_l2(qt, pt[0], 3)
    fused_topk.topk_l2_masked(qt, pt, torch.from_numpy(v), k)
    codes, cs, cp, ce, vt = _quant_args(q.shape[1])
    quant_lb2.quant_lb2(qt, codes, cs, cp, ce, vt, precision="int8")
    lpgf_force.lpgf_force(pt[0], 2.0, 1.0)
    assert (pairwise_l2.launches, fused_topk.topk_l2_launches,
            fused_topk.topk_l2_masked_launches, quant_lb2.launches,
            lpgf_force.launches) == before


def _quant_args(d, g=6, seed=0):
    """(codes, cscale, cppq, ceps, valid) for g queries over two tiles."""
    rng = np.random.default_rng(seed)
    planes = plan_tiles(_np((2, 16, d), seed), np.ones((2, 16), bool),
                        "int8")
    return (planes.data.reshape(1, 32, d).expand(g, -1, -1).contiguous(),
            planes.scale.repeat_interleave(16)[None].expand(g, -1)
            .contiguous(),
            planes.ppq.reshape(1, 32).expand(g, -1).contiguous(),
            planes.eps.repeat_interleave(16)[None].expand(g, -1)
            .contiguous(),
            torch.from_numpy(rng.random((g, 32)) < 0.7))


def test_lpgf_force_on_cuda_reaches_the_kernel(monkeypatch):
    """``ops.lpgf_force`` hands a CUDA tensor to the CUDA wrapper (faked
    here, as there is no card) and never to the plain version."""
    class _CudaTensor:
        device = torch.device("cuda")

        def float(self):
            return self

        def contiguous(self):
            return self
    seen = []
    monkeypatch.setattr(lpgf_force, "lpgf_force_cuda",
                        lambda x, r, g, c=1.1: seen.append((x, r, g, c)))
    monkeypatch.setattr(tref, "lpgf_force", lambda *a, **k: pytest.fail(
        "the plain version ran for a CUDA tensor"))
    t = _CudaTensor()
    ops.lpgf_force(t, 3.0, 1.5)
    assert seen == [(t, 3.0, 1.5, 1.1)]


@pytest.mark.parametrize("wrapper", ["pairwise_sq_l2_cuda", "topk_l2_cuda",
                                     "topk_l2_masked_cuda", "quant_lb2_cuda",
                                     "lpgf_force_cuda"])
def test_cuda_wrappers_reject_cpu_tensors(wrapper):
    """A kernel wrapper called by name with CPU tensors raises before any
    build or launch, rather than hand host pointers to the card."""
    q, p, v, k = _masked_case("plain")
    qt, pt, vt = torch.from_numpy(q), torch.from_numpy(p), torch.from_numpy(v)
    args = {"pairwise_sq_l2_cuda": (pairwise_l2, (qt, pt[0]), {}),
            "topk_l2_cuda": (fused_topk, (qt, pt[0], 3), {}),
            "topk_l2_masked_cuda": (fused_topk, (qt, pt, vt, k), {}),
            "quant_lb2_cuda": (quant_lb2, (qt, *_quant_args(q.shape[1])),
                               {"precision": "int8"}),
            "lpgf_force_cuda": (lpgf_force, (pt[0], 2.0, 1.0), {})}
    mod, a, kw = args[wrapper]
    with pytest.raises(ValueError, match="CUDA kernels take CUDA tensors"):
        getattr(mod, wrapper)(*a, **kw)
