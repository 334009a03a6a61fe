"""The port's MORBO (``repro_torch.core.morbo``) on the CPU: the
reference's Pareto and MORBO tests (``tests/test_feature_rep.py``), its
GP and driver robustness tests (``tests/test_reopt.py``), and parity with
the reference's numpy MORBO for the same seed and tells: the same asks,
evaluated points, objectives, Pareto mask and restarts, bit for bit.
"""
import numpy as np
import pytest
import torch

from repro.core import morbo as J
from repro_torch.core import morbo as T
from repro_torch.core.morbo import GP, MorboDriver, morbo_minimize, pareto_mask

torch.set_num_threads(1)


def _two_objectives(x):
    # conflicting: (x-1)^2 vs (x+1)^2 summed over dims
    return np.array([np.sum((x - 1) ** 2), np.sum((x + 1) ** 2)])


# ---------------------------------------------------------------------------
# the reference's tests on the port
# ---------------------------------------------------------------------------
def test_pareto_mask():
    y = np.array([[0, 1], [1, 0], [2, 2], [0.5, 0.5]])
    m = pareto_mask(y)
    assert m.tolist() == [True, True, False, True]


def test_morbo_minimizes_two_objectives():
    res = morbo_minimize(_two_objectives,
                         (np.full(3, -3.0), np.full(3, 3.0)),
                         n_objectives=2, n_init=8, iters=6, n_tr=2,
                         batch=3, seed=0)
    assert res.pareto.any()
    best = res.best_scalarized([0.5, 0.5])
    assert np.all(np.abs(best) <= 2.0)
    assert _two_objectives(best).sum() < \
        _two_objectives(np.full(3, 3.0)).sum()


def test_gp_survives_duplicate_and_constant_points():
    x = np.zeros((6, 3))                     # all-duplicate inputs
    y = np.full(6, 2.5)                      # constant objective
    gp = GP(x, y)
    mu, var = gp.posterior(np.random.default_rng(0).normal(size=(4, 3)))
    assert np.all(np.isfinite(mu)) and np.all(np.isfinite(var))
    assert np.all(var >= 0)
    s = gp.sample(np.zeros((2, 3)), np.random.default_rng(1))
    assert np.all(np.isfinite(s))


def test_morbo_driver_survives_degenerate_tell():
    lo = np.array([-1.0, -1.0])
    drv = MorboDriver((lo, -lo), n_objectives=2, n_init=4, n_tr=1,
                      batch=2, seed=0)
    for _ in range(3):
        xb = drv.ask()
        assert np.all(xb >= lo - 1e-9) and np.all(xb <= -lo + 1e-9)
        drv.tell(np.zeros((len(xb), 2)))     # constant multi-objective
    res = drv.result()
    assert len(res.x) == drv.n_evals and np.all(np.isfinite(res.y))


def test_driver_protocol_errors():
    drv = MorboDriver((np.zeros(2), np.ones(2)), n_objectives=2, seed=0)
    with pytest.raises(RuntimeError, match="without an outstanding"):
        drv.tell(np.zeros((1, 2)))
    drv.ask()
    with pytest.raises(RuntimeError, match="outstanding"):
        drv.ask()


# ---------------------------------------------------------------------------
# parity with the reference: the same draws, bit for bit
# ---------------------------------------------------------------------------
def _tells(kind, xb):
    if kind == "quadratic":
        return np.stack([_two_objectives(x) for x in xb])
    if kind == "constant":
        return np.zeros((len(xb), 2))
    # three objectives with repeated values: ties in the Pareto mask
    return np.stack([np.round([x.sum(), -x[0], np.abs(x).max()], 1)
                     for x in xb])


@pytest.mark.parametrize("kind,n_obj", [("quadratic", 2), ("constant", 2),
                                        ("ties", 3)])
@pytest.mark.parametrize("seed", [0, 7])
def test_driver_asks_match_reference(kind, n_obj, seed):
    lo = np.array([-0.6, -0.6, -0.3, -0.3])
    kw = dict(n_objectives=n_obj, n_init=6, n_tr=1, batch=2, seed=seed)
    jd, td = J.MorboDriver((lo, -lo), **kw), T.MorboDriver((lo, -lo), **kw)
    for _ in range(9):
        jx, tx = jd.ask(), td.ask()
        np.testing.assert_array_equal(tx, jx)
        y = _tells(kind, jx)
        jd.tell(y)
        td.tell(y)
    jr, tr = jd.result(), td.result()
    np.testing.assert_array_equal(tr.x, jr.x)
    np.testing.assert_array_equal(tr.y, jr.y)
    np.testing.assert_array_equal(tr.pareto, jr.pareto)
    assert tr.n_restarts == jr.n_restarts
    assert td.n_evals == jd.n_evals


def test_minimize_matches_reference():
    bounds = (np.full(3, -3.0), np.full(3, 3.0))
    kw = dict(n_objectives=2, n_init=8, iters=6, n_tr=2, batch=3, seed=0)
    jr = J.morbo_minimize(_two_objectives, bounds, **kw)
    tr = T.morbo_minimize(_two_objectives, bounds, **kw)
    np.testing.assert_array_equal(tr.x, jr.x)
    np.testing.assert_array_equal(tr.y, jr.y)
    np.testing.assert_array_equal(tr.pareto, jr.pareto)
    assert tr.n_restarts == jr.n_restarts
    np.testing.assert_array_equal(tr.best_scalarized([0.3, 0.7]),
                                  jr.best_scalarized([0.3, 0.7]))


def test_gp_posterior_matches_reference():
    rng = np.random.default_rng(3)
    x, y = rng.random((9, 4)), rng.normal(size=9)
    xq = rng.random((5, 4))
    for a, b in zip(T.GP(x, y).posterior(xq), J.GP(x, y).posterior(xq)):
        np.testing.assert_array_equal(a, b)
    dup = np.zeros((4, 4))
    assert T.GP(dup, np.ones(4)).degenerate == J.GP(dup, np.ones(4)).degenerate
