"""The port's serving examples (``repro_torch.examples.serve_retrieval``,
``serve_pipelined`` and ``serve_sharded``) on the CPU, held to their
contracts and to the JAX package, as tests/test_torch_examples.py holds
the others: each ``main(["--device", "cpu"])`` runs once per module, its
catalog is the reference examples' seeded draw, and every query it
answers gives, as a set of logical rows, the rows of
``repro.core.query.execute_bruteforce`` over a ``repro.core.lake`` table
of the same arrays. The catalog is cut from the examples' 20,000 rows to
``ROWS`` (10,000), each module's ``ROWS`` set with ``monkeypatch``: at
the full size the three ``prepare()`` calls alone take ~110 s on one
thread here. Every other size is the examples' own.
"""
import numpy as np
import pytest
import torch

from repro.core.lake import MMOTable as JTable
from repro_torch.core import query as TQ
from repro_torch.examples import (serve_pipelined, serve_retrieval,
                                  serve_sharded)

from test_torch_examples import assert_ref, catalog, ref_table

torch.set_num_threads(1)

ROWS = 10000


def _run(mod):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "ROWS", ROWS)
        return mod.main(["--device", "cpu"])


def _request_query(req, vec):
    """The query a ``RetrievalServer`` runs for ``req`` on vector ``vec``."""
    vk = TQ.VK.of(req.attr, vec, req.k)
    return vk if req.predicate is None else TQ.And.of(req.predicate, vk)


# ---------------------------------------------------------------------------
# serve_retrieval
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sr_run():
    return _run(serve_retrieval)


def test_serve_retrieval_catalog_is_the_reference_recipe(sr_run):
    _, vec, price = catalog(ROWS)
    t = sr_run["table"]
    assert np.array_equal(t.vector["v"], vec)
    assert np.array_equal(t.numeric["price"], price)


def test_serve_retrieval_batched_knn_is_the_reference_oracle(sr_run):
    """64 x top-10 through ``BatchedExecutor`` over the enhanced features:
    the brute force's rows over those features, distances the exact
    ones of the rows returned."""
    r = sr_run
    enh, qs = r["enhanced"], r["knn_queries"]
    assert qs.shape == (64, enh.shape[1]) and r["knn_rows"].shape == (64, 10)
    jt = JTable("enhanced").add_vector("e", enh)
    queries = [TQ.VK.of("e", q, 10) for q in qs]
    assert_ref(jt, queries, list(r["knn_rows"]))
    want = np.sqrt(((enh[r["knn_rows"]].astype(np.float64)
                     - qs[:, None, :].astype(np.float64)) ** 2).sum(-1))
    np.testing.assert_allclose(r["knn_dists"], want, rtol=1e-5, atol=1e-5)


def test_serve_retrieval_planned_hybrid_batch(sr_run):
    r = sr_run
    assert len(r["hybrid"]) == 64
    assert r["cache"] == "hit"
    assert (r["n_engine"], r["n_scalar"]) == (64, 0)
    assert r["knn_groups"] and all(seed > 0 for _, seed in r["knn_groups"])
    assert_ref(ref_table(r["table"]), r["hybrid"], r["hybrid_rows"],
               r["row_ids"])
    assert all(len(x) == 5 for x in r["hybrid_rows"])


def test_serve_retrieval_scalar_path_and_qbs(sr_run):
    r = sr_run
    assert_ref(ref_table(r["table"]), r["hybrid"][:20], r["scalar_rows"],
               r["row_ids"])
    for a, b in zip(r["scalar_rows"], r["hybrid_rows"][:20]):
        assert set(a.tolist()) == set(b.tolist())
    # 20 executions sampled at 20%
    assert 0 < r["qbs_rows"] < 20
    assert r["qbs_objectives"]["accuracy"] == 1.0


def test_serve_retrieval_server_over_the_embedder(sr_run):
    r = sr_run
    vecs = r["served_vectors"]
    assert vecs.shape == (8, 32) and np.isfinite(vecs).all()
    queries = [_request_query(q, v) for q, v in zip(r["requests"], vecs)]
    assert_ref(ref_table(r["table"]), queries, r["served_rows"],
               r["row_ids"])
    assert all(len(x) == 5 for x in r["served_rows"])


def test_serve_retrieval_generation(sr_run):
    toks = sr_run["gen_tokens"]
    assert len(toks) == 4
    for t in toks:
        assert t.shape == (8,) and t.min() >= 0 and t.max() < 256


# ---------------------------------------------------------------------------
# serve_pipelined
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def sp_run():
    return _run(serve_pipelined)


def test_serve_pipelined_catalog_is_the_reference_recipe(sp_run):
    _, vec, price = catalog(ROWS)
    t = sp_run["table"]
    assert np.array_equal(t.vector["v"], vec)
    assert np.array_equal(t.numeric["price"], price)
    assert len(sp_run["requests"]) == 256


def test_serve_pipelined_depths_identical(sp_run):
    r = sp_run
    assert r["identical"]
    assert len(r["rows"][1]) == len(r["rows"][3]) == 256
    for a, b in zip(r["rows"][1], r["rows"][3]):
        assert np.array_equal(a, b)
    assert r["qps"][1] > 0 and r["qps"][3] > 0


def test_serve_pipelined_rows_are_the_reference_oracle(sp_run):
    """The stub embeds a prompt as the physical table's row (first token
    mod n) + 0.01: each request's rows are the brute force's top-k."""
    r = sp_run
    vecs = r["vectors"]
    queries = [_request_query(q, vecs[int(q.tokens[0]) % len(vecs)] + 0.01)
               for q in r["requests"]]
    assert_ref(ref_table(r["table"]), queries, r["rows"][1], r["row_ids"])


def test_serve_pipelined_drain_barrier(sp_run):
    r = sp_run
    assert r["inflight_before"] >= 1
    assert r["inflight_after"] == 0
    assert r["resolved"] == r["pre_append"] == 32
    assert r["n_delta"] == 5


# ---------------------------------------------------------------------------
# serve_sharded
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ss_run():
    return _run(serve_sharded)


def test_serve_sharded_catalog_is_the_reference_recipe(ss_run):
    _, vec, price = catalog(ROWS)
    t = ss_run["table"]
    assert np.array_equal(t.vector["v"], vec)
    assert np.array_equal(t.numeric["price"], price)
    assert len(ss_run["queries"]) == 32


@pytest.mark.parametrize("shards", ["off", 1, 2, 8])
def test_serve_sharded_every_shard_count_runs_exact(ss_run, shards):
    """Every shard count runs on the one device (none skipped): rows the
    unsharded run's and the reference brute force's."""
    r = ss_run
    run = r["runs"][shards]
    assert run["plan_shards"] == (0 if shards == "off" else shards)
    assert run["identical"]
    for a, b in zip(run["rows"], r["runs"]["off"]["rows"]):
        assert set(a.tolist()) == set(b.tolist())
    assert_ref(ref_table(r["table"]), r["queries"], run["rows"],
               r["row_ids"])


def test_serve_sharded_default_shards_server(ss_run):
    r = ss_run
    assert r["server_shards"] == 2
    queries = [_request_query(q, v) for q, v in
               zip(r["requests"], r["served_vectors"])]
    assert_ref(ref_table(r["table"]), queries, r["served_rows"],
               r["row_ids"])
    assert [len(x) for x in r["served_rows"]] == [5, 5, 5]
