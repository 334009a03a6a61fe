"""Query-aware optimization ONLINE: the paper's §5.2.2 Step 4 loop run
against a live platform — serve a skewed workload, let the background
``ReoptController`` tune the hyperspace transform on the measured QBS
traffic, build the winner as a new index generation beside the serving
one, and swap it in with zero downtime (then roll it back, from the
same one-call API).

    PYTHONPATH=src python -m repro_torch.examples.query_aware_tuning \\
        [--device cpu]

Contrast examples of the OFFLINE loop (``morbo_minimize`` +
``objectives_for_morbo``): there the platform is re-prepared in place
between evaluations — queries stop while the index rebuilds. Here the
serving index is never touched until the single atomic ``swap()``:
every ``execute`` before, during, and after the cycle is oracle-exact.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import query as Q
from repro_torch.core.lake import MMOTable
from repro_torch.core.platform import MQRLD
from repro_torch.core.reopt import ReoptConfig, ReoptController

MAX_STEPS = 80          # controller steps before giving up on a swap


def _exact(p, queries) -> tuple:
    """(rows of the serving view, [(logical rows, logical truth) of each
    query]): the physical layout changes with every generation, so rows
    are compared through the view's row ids."""
    view = p.view()
    out = []
    for q in queries:
        got = view.row_ids[p.execute(q, record=False)[0]]
        want = view.row_ids[p.oracle(q)]
        out.append((np.sort(got), np.sort(want)))
    return view.n_rows, out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n, d = 4000, 8
    centers = rng.normal(size=(6, d)).astype(np.float32) * 5
    vec = (centers[rng.integers(0, 6, n)]
           + rng.normal(size=(n, d))).astype(np.float32)
    price = rng.uniform(0, 100, n).astype(np.float32)
    table = (MMOTable("tune").add_vector("v", vec)
             .add_numeric("price", price))
    p = MQRLD(table, seed=0, device=dev)
    p.prepare(use_transform=True, use_lpgf=False, min_leaf=16, max_leaf=256)
    p.fold_mode = "background"           # appends never pay the merge

    # skewed live traffic (the query-aware mechanism's reason to exist):
    # hot vector probes + one filtered archetype, recorded into the QBS
    hot = vec[rng.integers(0, 400, 12)]
    workload = [Q.VK.of("v", h, 10) for h in hot]
    workload += [Q.And.of(Q.NR("price", 20, 80), Q.VK.of("v", h, 8))
                 for h in hot[:4]]
    base = [p.execute(q)[1] for q in workload]       # record=True: QBS
    cbr0 = float(np.mean([s.cbr for s in base]))
    print(f"serving gen {p.generation}: "
          f"cbr={cbr0:.3f} "
          f"time={np.mean([s.time_s for s in base]) * 1e3:.2f}ms")
    checks = {"serving": _exact(p, workload[:4])}

    # the background tuner: each step() is one bounded unit of work the
    # serving loop runs between micro-batches (RetrievalServer.poll()
    # drives it automatically via attach_reopt; here we step by hand)
    ctl = ReoptController(p, config=ReoptConfig(
        interval_s=0.0, min_queries=8, sample_rows=512, max_workload=10,
        n_params=4, n_init=5, tune_cycles=2, evals_per_step=2, seed=0))
    events, steps = [], 0
    while ctl.n_swaps == 0 and steps < MAX_STEPS:
        evt = ctl.step()
        steps += 1
        if evt != events[-1] if events else True:
            events.append(evt)
        if evt == "no-improvement":      # keep measuring, try again
            for q in workload:
                p.execute(q)
    print(f"reopt: {steps} cooperative steps -> {' -> '.join(events)}")
    out = dict(steps=steps, events=events, n_swaps=ctl.n_swaps,
               cbr_before=cbr0, table=table, workload=workload)

    if ctl.n_swaps:
        win = next(e for e in ctl.history if e.kind == "swap")
        opt = [p.execute(q, record=False)[1] for q in workload]
        cbr1 = float(np.mean([s.cbr for s in opt]))
        print(f"swapped to gen {win.gen_id}: "
              f"cbr={cbr1:.3f} "
              f"baseline->best objectives {win.baseline} -> {win.best}")
        checks["swap"] = _exact(p, workload[:4])
        out.update(swap_gen=win.gen_id, cbr_after=cbr1,
                   baseline=win.baseline, best=win.best)

        # background fold: appends mark fold_due; the controller folds
        # beside and swaps — the appender never blocks on the merge
        p.append(numeric={"price": np.float32([55.0])},
                 vector={"v": hot[:1] + 0.1}, fold=None)
        p.auto_fold_ratio = 1e-9
        while p.n_delta:
            ctl.step()
        print(f"background fold drained the delta (gen {p.generation})")
        checks["fold"] = _exact(p, workload[:4])
        out.update(fold_gen=p.generation, appended=dict(
            price=np.float32([55.0]), v=hot[:1] + 0.1))

        # one-call rollback: the previous generation was retained
        p.rollback()
        print(f"rolled back (gen {p.generation})")
        out.update(rollback_gen=p.generation)

    # every phase keeps exactness — including across swap and rollback
    # (physical layout changed, so compare logically via the oracle)
    checks["final"] = _exact(p, workload[:4])
    for got, want in checks["final"][1]:
        assert np.array_equal(got, want)
    print("exactness preserved through tuning, swap, fold, rollback")
    out.update(checks=checks,
               exact=all(np.array_equal(g, w) for _, c in checks.values()
                         for g, w in c))
    return out


if __name__ == "__main__":
    main()
