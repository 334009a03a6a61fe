"""The comparison that decides ``correct`` fails when the timed path is
broken underneath a run (an answer altered where it is produced, half
of a batch's answers left out, a query vector altered), and its control
(the reference one precision below the configuration's) fails it too,
while the program's own readings pass."""
import numpy as np
import pytest

from perfbench import harness, spec
from perfbench.harness import Ctx
from perfbench.record import Recorder


def _run(bench, cell):
    path, dirs = bench
    out, code = harness.run(cell, 77, 1.0, False, device="cpu",
                            benchmark=path, dirs=dirs)
    assert code == 0
    return out


def _altered(rows):
    """Each answer's first row swapped for another row of the table."""
    out = []
    for r in rows:
        r = np.array(r, copy=True)
        if len(r):
            r[0] = (r[0] + 1) % 2000 if (r[0] + 1) % 2000 not in r else \
                (r[0] + 7) % 2000
        out.append(r)
    return out


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
def test_batch_faults_come_out_not_correct(bench, monkeypatch, fault):
    from repro_torch.core.planner import ExecutablePlan
    real = ExecutablePlan.execute

    def broken(self):
        rows, stats = real(self)
        if fault == "answer_altered":
            return _altered(rows), stats
        half = len(rows) // 2
        return rows[:half] + [np.empty(0, np.int64)] * (len(rows) - half), \
            stats
    monkeypatch.setattr(ExecutablePlan, "execute", broken)
    out = _run(bench, "tiny-blobs.hybrid")
    assert out["correct"] is False
    assert out["compared"]["mismatched_queries"]["value"] > 0


@pytest.mark.parametrize("fault", ["answer_altered", "vector_altered"])
def test_serve_faults_come_out_not_correct(bench, monkeypatch, fault):
    from repro_torch.serve.engine import RetrievalServer
    if fault == "answer_altered":
        real = RetrievalServer._ranked

        def broken(self, req, emb, rows):
            return _altered([real(self, req, emb, rows)])[0]
        monkeypatch.setattr(RetrievalServer, "_ranked", broken)
    else:
        real = RetrievalServer._queries

        def broken(self, reqs, emb):
            noise = np.random.default_rng(0).normal(size=emb.shape)
            e = emb + 0.2 * noise.astype(np.float32) / np.sqrt(emb.shape[1])
            return real(self, reqs, e / np.linalg.norm(e, axis=1,
                                                       keepdims=True))
        monkeypatch.setattr(RetrievalServer, "_queries", broken)
    out = _run(bench, "tiny-text.serve")
    assert out["correct"] is False
    c = out["compared"]
    key = "mismatched_requests" if fault == "answer_altered" \
        else "query_vector_gap"
    assert c[key]["value"] > c[key]["limit"]


@pytest.mark.parametrize("cell", ["tiny-blobs.hybrid", "tiny-text.serve"])
def test_control_fails_and_the_program_passes(bench, cell):
    path, dirs = bench
    c = spec.load(cell, benchmark=path, dirs=dirs)
    kind = spec.load_module("traffic", c.workload["kind"], c.dirs)
    limits = c.workload["limits"]
    for seed in (5, 6, 7):
        ctx = Ctx(c, seed, 0, "cpu", Recorder())
        control = kind.control(ctx)
        assert any(v > limits[k] for k, v in control.items())
        if hasattr(kind, "sound"):
            for k, v in kind.sound(ctx).items():
                assert v <= limits[k] / 3
