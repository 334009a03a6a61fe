"""The port's query and build modules against the JAX package on the same
numpy inputs: query signatures and the brute-force oracle, the
hyperspace transform, LPGF on both of its branches, DPC and the index
build. Also the package's import and device rules.

Tolerance: trees, labels, ids and rows exact; floats rtol=1e-5,
atol=1e-5 (fp32 summation order, XLA vs torch's CPU GEMM).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import query as JQ
from repro.core.dpc import dpc as jdpc
from repro.core.index import build_index as jbuild_index
from repro.core.lake import MMOTable as JTable
from repro.core.lpgf import lpgf as jlpgf
from repro.core.lpgf import mean_nn_distance as jmean_nn
from repro.core.platform import MQRLD as JMQRLD
from repro.core.transform import init_transform as jinit_transform
from repro_torch.core import lpgf as tlpgf_mod
from repro_torch.core import query as TQ
from repro_torch.core.dpc import dpc as tdpc
from repro_torch.core.index import build_index as tbuild_index
from repro_torch.core.lake import MMOTable as TTable
from repro_torch.core.lpgf import lpgf as tlpgf
from repro_torch.core.lpgf import mean_nn_distance as tmean_nn
from repro_torch.core.platform import MQRLD
from repro_torch.core.transform import init_transform as tinit_transform

torch.set_num_threads(1)

RTOL = ATOL = 1e-5   # fp32 summation order (XLA vs torch CPU GEMM)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _table_pair(n=400, d=6, seed=0):
    rng = np.random.default_rng(seed)
    vec = rng.normal(size=(n, d)).astype(np.float32)
    price = rng.uniform(0, 100, n).astype(np.float32)
    cat = rng.integers(0, 5, n).astype(np.float32)
    mk = lambda T: (T("t").add_vector("v", vec).add_numeric("price", price)
                    .add_numeric("cat", cat))
    return mk(JTable), mk(TTable), vec


def _queries(M, vec, seed=1):
    """The same query trees built from either package's AST classes."""
    rng = np.random.default_rng(seed)
    out = []
    for j in range(12):
        v = vec[rng.integers(len(vec))]
        out += [
            M.VK.of("v", v, 5),
            M.And.of(M.NR("price", 20, 70), M.VK.of("v", v, 7)),
            M.And.of(M.VR.of("v", v, 2.5), M.NE("cat", 3.0)),
            M.Or.of(M.NE("cat", 1.0), M.And.of(M.VR.of("v", v, 2.0),
                                                M.NR("price", 0, 50))),
            M.And.of(M.And.of(M.NR("price", 10, 90), M.NE("cat", 2.0)),
                     M.VK.of("v", v, 4)),
        ]
    return out


def test_signatures_and_bruteforce_rows_equal():
    jt, tt, vec = _table_pair()
    for jq, tq in zip(_queries(JQ, vec), _queries(TQ, vec)):
        jn, tn = JQ.normalize(jq), TQ.normalize(tq)
        assert JQ.signature(jn) == TQ.signature(tn)
        np.testing.assert_array_equal(JQ.execute_bruteforce(jt, jq),
                                      TQ.execute_bruteforce(tt, tq))


@pytest.mark.parametrize("block", [1, 7, 2048])
def test_oracle_distances_blocked_bit_for_bit(block):
    """The oracle's row-blocked distances are the one-pass sums bit for
    bit, over all rows and over a subset; its rows stay the reference's
    on a table several blocks long."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(5000, 64)) * 30 + 200).astype(np.float32)
    v = rng.normal(size=64).astype(np.float32)
    for rows in (np.arange(5000), np.sort(rng.choice(5000, 777, False))):
        np.testing.assert_array_equal(
            TQ._sq_dists(x, rows, v, block=block),
            np.sum((x[rows] - v[None, :]) ** 2, axis=1))
    assert TQ._sq_dists(x, rows[:0], v, block=block).shape == (0,)
    jt, tt, vec = _table_pair(n=5000, d=64, seed=block)
    for jq, tq in zip(_queries(JQ, vec), _queries(TQ, vec)):
        np.testing.assert_array_equal(JQ.execute_bruteforce(jt, jq),
                                      TQ.execute_bruteforce(tt, tq))


def test_init_transform_matches():
    x = np.random.default_rng(2).normal(size=(500, 9)).astype(np.float32)
    x[:, 0] *= 5
    j, t = jinit_transform(x), tinit_transform(x)
    for a, b in ((j.r, t.r), (j.s, t.s), (j.mean, t.mean)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(j.apply(x), t.apply(x), rtol=RTOL, atol=ATOL)


def _grid_points(n, d, seed):
    """Quarter-integer coordinates: every squared distance, on both
    packages, is exact in fp32, so LPGF's self-masking and ring
    thresholds see identical values."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-12, 13, (n, d)) * 0.25).astype(np.float32)


def test_mean_nn_distance_matches():
    x = _grid_points(700, 5, 3)
    j = jmean_nn(x, sample=300, seed=4)
    t = tmean_nn(x, sample=300, seed=4, device="cpu")
    assert abs(j - t) <= ATOL + RTOL * abs(j)


@pytest.mark.parametrize("n,block,iters", [(300, 4096, 2), (700, 256, 1)])
def test_lpgf_matches_on_both_branches(n, block, iters):
    """N <= block goes through lpgf_force, N > block through the tiled
    pairwise + GEMM path (``_tile_disp``). The tiled path masks self
    pairs by ``d2 <= 1e-12``, which only exact distances make reliable,
    so it is compared on one step (the platform default) from grid
    points; the moved points of a second step are no longer exact."""
    x = _grid_points(n, 4, 5)
    j = jlpgf(x, iters=iters, block=block, seed=1)
    t = tlpgf(x, iters=iters, block=block, seed=1, device="cpu")
    # moved points, not squared distances: two steps compound the fp32
    # summation-order difference (about 3e-5 on these inputs)
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("chunk", [100, 256])
def test_lpgf_tile_row_chunks_match_reference(monkeypatch, chunk):
    """``_tile_disp`` evaluates each tile in row chunks (1024 rows at the
    default): ragged and whole-tile chunks of a 256-row tile return the
    reference's moved points."""
    monkeypatch.setattr(tlpgf_mod, "_ROW_CHUNK", chunk)
    x = _grid_points(700, 4, 5)
    j = jlpgf(x, iters=1, block=256, seed=1)
    t = tlpgf(x, iters=1, block=256, seed=1, device="cpu")
    np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_small_table_prepare_goes_through_lpgf_force(monkeypatch):
    """prepare() on a table of at most 4096 rows moves its points with
    ``ops.lpgf_force`` (on the card, the force kernel): the moved
    features equal the reference's, and queries return the oracle's rows
    and the reference's. Grid points without the transform keep every
    ring decision exact on both sides."""
    x = _grid_points(1500, 6, 7)
    calls = []
    real = tlpgf_mod.ops.lpgf_force
    monkeypatch.setattr(tlpgf_mod.ops, "lpgf_force",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    kw = dict(use_transform=False, lpgf_iters=1, min_leaf=32, max_leaf=256)
    p = JMQRLD(JTable("s").add_vector("v", x), seed=0)
    p.prepare(**kw)
    pt = MQRLD(TTable("s").add_vector("v", x), seed=0, device="cpu")
    pt.prepare(**kw)
    assert calls == [x.shape]

    def raw(m):
        return m.enhanced[np.argsort(m.table.row_ids)]
    np.testing.assert_allclose(raw(pt), raw(p), rtol=RTOL, atol=ATOL)
    for i in (0, 700, 1499):
        tq, jq = TQ.VK.of("v", x[i], 15), JQ.VK.of("v", x[i], 15)
        (g,), _ = pt.session().plan([tq]).execute()
        (w,), _ = p.session().plan([jq]).execute()
        np.testing.assert_array_equal(g, pt.oracle(tq))
        np.testing.assert_array_equal(np.sort(pt.table.row_ids[g]),
                                      np.sort(p.table.row_ids[w]))


def test_dpc_labels_identical(blobs):
    x, _, _ = blobs
    j = jdpc(x[:800], max_clusters=8, seed=0)
    t = tdpc(x[:800], max_clusters=8, seed=0, device="cpu")
    np.testing.assert_array_equal(j.labels, t.labels)
    np.testing.assert_array_equal(j.centers, t.centers)


def test_build_index_trees_identical(blobs):
    x, _, _ = blobs
    kw = dict(min_leaf=32, max_leaf=256, dpc_sample=512, seed=0)
    jt, jperm, _ = jbuild_index(x, **kw)
    tt, tperm, rep = tbuild_index(x, device="cpu", **kw)
    np.testing.assert_array_equal(jperm, tperm)
    assert jt.children == tt.children
    for f in ("parent", "is_leaf", "bucket_start", "bucket_end", "depth"):
        np.testing.assert_array_equal(getattr(jt, f), getattr(tt, f))
    for f in ("centroid", "radius", "lm_a", "lm_b"):
        np.testing.assert_allclose(getattr(jt, f), getattr(tt, f),
                                   rtol=RTOL, atol=ATOL)
    assert rep.n_leaves == len(tt.leaf_ids) > 1


def test_import_leaves_jax_and_reference_out():
    """Every port module, and chip_smoke.py, imports neither JAX nor the
    reference package."""
    code = ("import sys, importlib, pkgutil, repro_torch, chip_smoke\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC), os.path.abspath(os.path.join(SRC, ".."))]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_default_device_is_the_card():
    _, tt, _ = _table_pair(n=20)
    if torch.cuda.is_available():
        assert MQRLD(tt).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            MQRLD(tt)
    assert MQRLD(tt, device="cpu").device.type == "cpu"


def test_every_kernel_source_is_built_and_bound():
    """``build.SOURCES`` lists every CUDA source of the package (the six
    TPU kernels' counterparts in five files, and the wgmma flash kernel
    beside the SIMT one) and ``build.SIGNATURES`` binds a launch entry
    point for each."""
    from repro_torch.kernels import build
    on_disk = sorted(f[:-3] for f in os.listdir(build.CSRC)
                     if f.endswith(".cu"))
    assert sorted(build.SOURCES) == on_disk == sorted(build.SIGNATURES)
    assert "flash_attention" in build.SOURCES
    assert "flash_attention_wgmma" in build.SOURCES
    assert "flash_attention_wgmma_launch" in \
        build.SIGNATURES["flash_attention_wgmma"]
    # one distance tile for pairwise_sq_l2, topk_l2 and lpgf_force, in a
    # header
    assert build.headers("pairwise_l2") == ["l2_tile.cuh"]
    assert build.headers("fused_topk") == ["l2_tile.cuh"]
    assert build.headers("lpgf_force") == ["l2_tile.cuh"]
    assert set(build.SIGNATURES["lpgf_force"]) == {"lpgf_force_launch"}
    assert {"topk_l2_splits", "topk_l2_reg_k", "topk_l2_scratch_bytes",
            "topk_l2_launch", "topk_l2_merge_launch"} <= \
        set(build.SIGNATURES["fused_topk"])
    for name, fns in build.SIGNATURES.items():
        assert any(fn.endswith("_launch") for fn in fns), name
        with open(os.path.join(build.CSRC, f"{name}.cu")) as f:
            src = f.read()
        for fn in fns:
            assert re.search(r'extern "C" [\w ]+ ' + fn + r"\(", src), fn


def test_shared_header_enters_the_build_hash(tmp_path, monkeypatch):
    """A library's name carries the hash of its source and of every
    ``csrc/`` header it includes, so an edited header rebuilds the four
    libraries that include it (the SIMT flash kernel takes its
    ``cp.async`` helpers) and no other."""
    import shutil
    from repro_torch.kernels import build
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", str(csrc))
    before = {n: build._target(n) for n in build.SOURCES}
    with open(csrc / "l2_tile.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: build._target(n) for n in build.SOURCES}
    changed = sorted(n for n in build.SOURCES if before[n] != after[n])
    assert changed == ["flash_attention", "fused_topk", "lpgf_force",
                       "pairwise_l2"]


def test_spill_bytes_reads_each_entry_function():
    """``build.spill_bytes`` pairs each entry function of a ``ptxas -v``
    report with its spill stores plus loads."""
    from repro_torch.kernels import build
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z14lpgf_wx_kernelPKf' for 'sm_90a'
ptxas info    : Function properties for _Z14lpgf_wx_kernelPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 254 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z16transpose_kernelPKf' for 'sm_90a'
ptxas info    : Function properties for _Z16transpose_kernelPKf
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
"""
    assert build.spill_bytes(report) == {"_Z14lpgf_wx_kernelPKf": 0,
                                         "_Z16transpose_kernelPKf": 16}
    assert build.spill_bytes("") == {}
