"""The port's examples (``repro_torch.examples``) on the CPU, held to their
contracts and to the JAX package: quickstart, precision_scan,
query_aware_tuning and train_embedder (the serving examples are in
tests/test_torch_examples_serve.py).

Each example's ``main(["--device", "cpu", ...])`` runs once per module
and its returned dict is read. Every query it answers is held, as a set
of logical rows (physical rows through the serving view's ``row_ids``),
to ``repro.core.query.execute_bruteforce`` over a ``repro.core.lake``
table built from the same numpy arrays, which are also held to the
reference example's seeded recipe. Sizes are the examples' own, except
``train_embedder``'s, cut to keep the file within its time here (one
thread): ``--steps 20`` (of 200; the loss must still fall) and
``DOCS`` 500 (of 2,000) documents embedded, set with ``monkeypatch``.
"""
import os

import numpy as np
import pytest
import torch

from repro.core import measurement as jmeas
from repro.core import query as JQ
from repro.core.lake import DataLake as JLake
from repro.core.lake import MMOTable as JTable
from repro_torch.examples import (precision_scan, query_aware_tuning,
                                  quickstart, serve_pipelined,
                                  serve_retrieval, serve_sharded,
                                  train_embedder)

torch.set_num_threads(1)

EXAMPLES = (quickstart, precision_scan, query_aware_tuning, serve_retrieval,
            serve_pipelined, serve_sharded, train_embedder)


# ---------------------------------------------------------------------------
# Helpers shared with test_torch_examples_serve.py
# ---------------------------------------------------------------------------
def to_ref(q):
    """The reference's query AST of a port query (same fields)."""
    name = type(q).__name__
    if name in ("And", "Or"):
        return getattr(JQ, name)(tuple(to_ref(x) for x in q.parts))
    return getattr(JQ, name)(**vars(q))


def ref_table(t, extra=None):
    """A ``repro.core.lake.MMOTable`` of the port table ``t``'s columns,
    with ``extra`` ({column: rows}) appended after them."""
    extra = extra or {}
    jt = JTable(t.name)
    for k, v in t.vector.items():
        jt.add_vector(k, np.concatenate([v, extra[k]]) if k in extra else v)
    for k, v in t.numeric.items():
        jt.add_numeric(k, np.concatenate([v, extra[k]]) if k in extra else v)
    return jt


def ref_rows(jt, q) -> set:
    return set(JQ.execute_bruteforce(jt, to_ref(q)).tolist())


def assert_ref(jt, queries, rows, row_ids=None):
    """Each query's rows (mapped through ``row_ids``), as a set, are the
    reference brute force's over ``jt``."""
    assert len(queries) == len(rows)
    for i, (q, r) in enumerate(zip(queries, rows)):
        got = np.asarray(r) if row_ids is None else row_ids[np.asarray(r)]
        assert set(got.tolist()) == ref_rows(jt, q), f"query {i}"


def catalog(n=20000, d=32, seed=0):
    """The serving examples' catalog, as the reference examples draw it:
    (rng after the draws, vec, price)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)).astype(np.float32) * 6
    cat = rng.integers(0, 12, n)
    vec = (centers[cat] + rng.normal(size=(n, d))).astype(np.float32)
    price = rng.uniform(0, 100, n).astype(np.float32)
    return rng, vec, price


@pytest.mark.parametrize("mod", EXAMPLES, ids=lambda m: m.__name__)
def test_main_without_card_raises(mod, monkeypatch):
    """``main([])`` means the card: without one it raises rather than
    running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qs_run(tmp_path_factory):
    lake = str(tmp_path_factory.mktemp("lake"))
    return quickstart.main(["--device", "cpu", "--lake", lake])


def test_quickstart_data_is_the_reference_recipe(qs_run):
    rng = np.random.default_rng(0)
    n = 5000
    centers = rng.normal(size=(8, 32)).astype(np.float32) * 6
    cat = rng.integers(0, 8, n)
    img = (centers[cat] + rng.normal(size=(n, 32))).astype(np.float32)
    t = qs_run["table"]
    assert np.array_equal(t.vector["image"], img)
    assert np.array_equal(t.numeric["price"],
                          rng.uniform(1, 100, n).astype(np.float32))
    assert np.array_equal(t.numeric["delivery_h"],
                          rng.uniform(0, 72, n).astype(np.float32))


def test_quickstart_fig1_rows_are_the_reference_oracle(qs_run):
    r = qs_run
    assert r["exact"]
    assert set(r["rows"].tolist()) == set(r["truth"].tolist())
    assert_ref(ref_table(r["table"]), [r["query"]], [r["rows"]],
               r["row_ids"])
    # the Fig. 1 query: 10 rows (the filter leaves more than 10)
    assert len(r["rows"]) == 10


def test_quickstart_mmos_and_index(qs_run):
    r = qs_run
    ids = r["row_ids"][r["rows"][:3]]
    assert r["uris"] == [f"s3://catalog/{i}.jpg" for i in ids]
    assert r["n_leaves"] > 1 and 0 < r["cbr"] <= 1
    assert r["changed"] >= 0
    assert 0 <= r["qbs_score"] <= 1


def test_quickstart_lake_lists_under_the_reference(qs_run):
    r = qs_run
    assert r["lake_tables"] == ["products"]
    assert JLake(r["lake"]).list_tables() == r["lake_tables"]
    jt = JLake(r["lake"]).read("products")
    assert jt.n_rows == 5000
    assert np.array_equal(np.sort(jt.row_ids), np.arange(5000))
    assert os.path.isfile(os.path.join(r["lake"], "products",
                                       "manifest.json"))


# ---------------------------------------------------------------------------
# precision_scan
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ps_run():
    return precision_scan.main(["--device", "cpu"])


def test_precision_scan_data_is_the_reference_recipe(ps_run):
    _, vec, price = catalog()
    t = ps_run["table"]
    assert np.array_equal(t.vector["v"], vec)
    assert np.array_equal(t.numeric["price"], price)
    assert len(ps_run["queries"]) == 32


@pytest.mark.parametrize("prec", ["fp32", "bf16", "int8"])
def test_precision_scan_rows_identical_and_exact(ps_run, prec):
    r = ps_run
    run = r["precisions"][prec]
    assert run["identical_to_fp32"]
    for a, b in zip(run["rows"], r["precisions"]["fp32"]["rows"]):
        assert np.array_equal(a, b)
    assert_ref(ref_table(r["table"]), r["queries"], run["rows"],
               r["base_row_ids"])
    resc = run["rescue"]
    if prec == "fp32":
        assert resc["scanned"] == 0
    else:
        assert resc["scanned"] > 0
        assert 0 <= resc["rescued"] <= resc["scanned"]
        assert resc["ratio"] == pytest.approx(
            resc["rescued"] / resc["scanned"])


def test_precision_scan_base_plus_delta(ps_run):
    r = ps_run
    assert r["delta_identical"]
    assert len(r["delta_row_ids"]) == 20500
    jt = ref_table(r["table"], {"v": r["appended"]["v"],
                                "price": r["appended"]["price"]})
    assert_ref(jt, r["queries"], r["delta_rows"], r["delta_row_ids"])
    assert_ref(jt, r["queries"], r["delta_rows_int8"], r["delta_row_ids"])


def test_precision_scan_default_int8(ps_run):
    r = ps_run
    assert r["default_mp_scanned"] > 0
    assert 0 <= r["default_mp_rescued"] <= r["default_mp_scanned"]
    for a, b in zip(r["default_rows"], r["delta_rows"]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# query_aware_tuning
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def qt_run():
    return query_aware_tuning.main(["--device", "cpu"])


def test_query_aware_tuning_data_is_the_reference_recipe(qt_run):
    rng = np.random.default_rng(0)
    n, d = 4000, 8
    centers = rng.normal(size=(6, d)).astype(np.float32) * 5
    vec = (centers[rng.integers(0, 6, n)]
           + rng.normal(size=(n, d))).astype(np.float32)
    t = qt_run["table"]
    assert np.array_equal(t.vector["v"], vec)
    assert np.array_equal(t.numeric["price"],
                          rng.uniform(0, 100, n).astype(np.float32))
    assert len(qt_run["workload"]) == 16


def test_query_aware_tuning_swap_fold_rollback(qt_run):
    r = qt_run
    assert r["steps"] <= query_aware_tuning.MAX_STEPS
    assert r["n_swaps"] >= 1, r["events"]
    assert r["events"][-1] == "swapped"
    assert set(r["checks"]) == {"serving", "swap", "fold", "final"}
    assert r["fold_gen"] > r["swap_gen"]
    assert r["exact"]


@pytest.mark.parametrize("phase", ["serving", "swap", "fold", "final"])
def test_query_aware_tuning_exact_after_each_phase(qt_run, phase):
    """4 queries after each phase: the port's rows equal its oracle's and
    the reference brute force's over the rows the view held then (the
    appended row is id 4000 once it is in)."""
    r = qt_run
    n_rows, pairs = r["checks"][phase]
    extra = None
    if n_rows == 4001:
        extra = {k: v for k, v in r["appended"].items()}
    else:
        assert n_rows == 4000
    jt = ref_table(r["table"], extra)
    assert len(pairs) == 4
    for q, (got, want) in zip(r["workload"][:4], pairs):
        assert np.array_equal(got, want)
        assert set(got.tolist()) == ref_rows(jt, q)


# ---------------------------------------------------------------------------
# train_embedder
# ---------------------------------------------------------------------------
TE_STEPS, TE_DOCS = 20, 500


@pytest.fixture(scope="module")
def te_run(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ckpt"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_embedder, "DOCS", TE_DOCS)
        return train_embedder.main(["--device", "cpu", "--steps",
                                    str(TE_STEPS), "--ckpt", ck])


def test_train_embedder_trains_and_the_loss_falls(te_run):
    r = te_run
    cfg = r["cfg"]
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (4, 256, 4096)
    assert r["steps_run"] == TE_STEPS and r["skipped"] == 0
    assert len(r["losses"]) == TE_STEPS
    assert all(np.isfinite(r["losses"]))
    assert r["loss_last"] < r["loss_first"]


def test_train_embedder_measurement_is_the_reference(te_run):
    r = te_run
    emb = r["emb"]
    assert emb.shape == (TE_DOCS, 256) and np.isfinite(emb).all()
    scores = jmeas.measure_models(emb.astype(np.float32),
                                  {"trained": emb, "noise": r["noise"]}, k=4)
    want = {s.model: round(s.score("IN"), 3) for s in scores}
    assert r["scores"] == want
    assert r["chose"] == jmeas.select_model(scores, method="IN").model


def test_train_embedder_hybrid_query_is_the_reference_oracle(te_run):
    r = te_run
    assert r["exact"]
    assert len(r["rows"]) == 10
    assert_ref(ref_table(r["table"]), [r["query"]], [r["rows"]],
               r["row_ids"])
