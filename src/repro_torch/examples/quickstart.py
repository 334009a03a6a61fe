"""Quickstart: build an MQRLD platform over a synthetic product catalog and
run rich hybrid queries.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--device cpu] [--lake /tmp/mqrld_lake]

The lake is written in the reference's format: ``repro.core.lake``'s
``DataLake`` over the same directory lists the same tables.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import query as Q
from repro_torch.core.lake import DataLake, MMOTable
from repro_torch.core.platform import MQRLD


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--lake", default="/tmp/mqrld_lake",
                    help="the data lake's root directory")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n = 5000
    # "image" embeddings with 8 product categories + numeric attributes
    centers = rng.normal(size=(8, 32)).astype(np.float32) * 6
    cat = rng.integers(0, 8, n)
    img = (centers[cat] + rng.normal(size=(n, 32))).astype(np.float32)
    price = rng.uniform(1, 100, n).astype(np.float32)
    delivery = rng.uniform(0, 72, n).astype(np.float32)

    table = (MMOTable("products")
             .add_vector("image", img, model="clip-analog")
             .add_numeric("price", price)
             .add_numeric("delivery_h", delivery)
             .with_raw([f"s3://catalog/{i}.jpg" for i in range(n)]))

    platform = MQRLD(table, seed=0, device=dev)
    report = platform.prepare(min_leaf=32, max_leaf=512)
    print(f"index: {report.n_leaves} buckets, depth {report.max_depth}, "
          f"last-mile hit ratio {report.lm_hit_ratio:.3f}, "
          f"{report.index_bytes/1024:.1f} KiB")

    # the paper's Fig 1 query: cheap cups that look like mine, delivered soon
    query = Q.And.of(
        Q.NR("price", 10, 20),
        Q.NR("delivery_h", 0, 24),
        Q.VK.of("image", img[42], 10),
    )
    rows, stats = platform.execute(query, task="fig1")
    print(f"query touched {stats.buckets_touched}/{report.n_leaves} buckets "
          f"(CBR {stats.cbr:.3f}), scanned {stats.rows_scanned} rows")
    mmos = platform.table.get_mmos(rows[:3])
    for mmo in mmos:
        print(f"  -> {mmo['raw_uri']}  price={mmo['price']:.2f} "
              f"delivery={mmo['delivery_h']:.1f}h")

    # verify against the exact oracle
    truth = platform.oracle(query)
    assert set(rows.tolist()) == set(truth.tolist())
    print("results verified exact vs brute force")

    # query-aware optimization: reorder hot tree paths (Algorithm 3)
    workload = [Q.VK.of("image", img[i], 10)
                for i in rng.integers(0, n, 30)]
    changed = platform.optimize_index(workload)
    print(f"Algorithm 3 reordered {changed} sibling lists")

    # persist the lake
    lake = DataLake(args.lake)
    lake.write(platform.table)
    tables = lake.list_tables()
    print("lake tables:", tables)
    score = round(platform.qbs.extrinsic_score(), 3)
    print("QBS extrinsic score:", score)
    return dict(query=query, rows=rows, truth=truth, exact=True,
                n_leaves=report.n_leaves, max_depth=report.max_depth,
                cbr=stats.cbr, rows_scanned=stats.rows_scanned,
                uris=[m["raw_uri"] for m in mmos], changed=changed,
                lake=args.lake, lake_tables=tables, qbs_score=score,
                table=table, row_ids=platform.view().row_ids)


if __name__ == "__main__":
    main()
