"""Mixed-precision tile scan: the ``precision`` knob.

The beam loop can scan tiles in int8 (per-tile symmetric scales) or
bf16 instead of fp32. Exactness is preserved, not approximated: the
quantized distance is widened by the analytic quantization-error bound
into a valid LOWER bound, candidates are refuted only on a strict
inequality against the running top-k threshold (ties always survive),
and the surviving frontier is rescored in fp32. Every precision
returns rows IDENTICAL to the fp32 path — the knob trades nothing but
the scan's arithmetic width.

    PYTHONPATH=src python -m repro_torch.examples.precision_scan \\
        [--device cpu]

On the card the reduced-precision rounds launch the ``quant_lb2`` kernel
(``csrc/quant_lb2.cu``: int8 or bf16 codes, per-tile scales); on the CPU
they take its plain version, so the QPS printed there is not the card's.
What this script demonstrates is the exactness contract and the knob's
reach: per-call, session-wide, env (``MQRLD_PRECISION``), and persisted
platform default.
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import query as Q
from repro_torch.core.lake import MMOTable
from repro_torch.core.platform import MQRLD


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n, d = 20000, 32
    centers = rng.normal(size=(12, d)).astype(np.float32) * 6
    cat = rng.integers(0, 12, n)
    vec = (centers[cat] + rng.normal(size=(n, d))).astype(np.float32)
    table = (MMOTable("catalog").add_vector("v", vec)
             .add_numeric("price",
                          rng.uniform(0, 100, n).astype(np.float32)))
    p = MQRLD(table, seed=0, device=dev)
    p.prepare(min_leaf=64, max_leaf=1024)
    print(f"platform ready: {n} MMOs")

    qs = [Q.And.of(Q.NR("price", 20, 80), Q.VK.of("v", vec[i], 10))
          for i in rng.integers(0, n, 32)]
    out = dict(table=table, queries=qs, base_row_ids=p.view().row_ids,
               precisions={})

    # same batch under each precision: rows must be identical
    baseline = None
    for prec in ("fp32", "bf16", "int8"):
        sess = p.session(precision=prec)
        sess.plan(qs).execute()             # warm + record QBS widths
        sess.plan(qs).execute()             # the seeded shapes
        t0 = time.time()
        rows, stats = sess.plan(qs).execute()
        dt = time.time() - t0
        if baseline is None:
            baseline = rows
        identical = all(np.array_equal(a, b)
                        for a, b in zip(rows, baseline))
        ex = sess.explain(qs)
        print(f"precision={prec}: {len(qs) / dt:.0f} qps, "
              f"identical_to_fp32={identical}, "
              f"rescue_ratio={ex['rescue']['ratio']:.3f} "
              f"({ex['rescue']['rescued']}/{ex['rescue']['scanned']})")
        out["precisions"][prec] = dict(
            rows=rows, qps=len(qs) / dt, identical_to_fp32=identical,
            rescue=dict(ex["rescue"]), mp_scanned=stats.mp_scanned,
            mp_rescued=stats.mp_rescued)

    # freshness: appended rows are quantized at sync with their own
    # per-tile scales — the contract holds over base+delta too
    m = 500
    new_price = rng.uniform(0, 100, m).astype(np.float32)
    new_vec = (centers[rng.integers(0, 12, m)]
               + rng.normal(size=(m, d))).astype(np.float32)
    p.append(numeric={"price": new_price}, vector={"v": new_vec},
             fold=False)
    ref, _ = p.session(precision="fp32").execute(qs)
    got, _ = p.session(precision="int8").execute(qs)
    delta_same = all(np.array_equal(a, b) for a, b in zip(ref, got))
    print("base+delta identical:", delta_same)
    out.update(appended=dict(price=new_price, v=new_vec),
               delta_rows=ref, delta_rows_int8=got,
               delta_identical=delta_same, delta_row_ids=p.view().row_ids)

    # the knob is a platform default too: persisted snapshots reload
    # with the int8 planes pre-quantized (core/persist.py quant.npz)
    p.default_precision = "int8"
    rows, stats = p.session().execute(qs)   # default -> int8
    print(f"default_precision=int8: scanned={stats.mp_scanned}, "
          f"rescued={stats.mp_rescued}")
    out.update(default_rows=rows, default_mp_scanned=stats.mp_scanned,
               default_mp_rescued=stats.mp_rescued)
    return out


if __name__ == "__main__":
    main()
