#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MQRLD (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed 0] [--rows 200000] [--dim 512]
                          [--batch 256]

Phases, each of which fails the run (non-zero exit) on any fault:

1. build: every kernel of the main path compiled from ``src/repro_torch/
   csrc`` with nvcc (one process per source, all started together);
2. kernels: each CUDA kernel against its plain PyTorch version on the
   card at the main path's shapes — ids exactly equal, squared distances
   within the fp32 dot-product error bound — and timed beside its plain
   version, a PyTorch library yardstick and its roofline bound;
3. main path: ``MQRLD(table).prepare()`` on a 200,000 x 512 table, then
   ``session().plan(batch).execute()`` on a 256-query hybrid batch (warm,
   then timed), every result row-equal to ``p.oracle(q)``, with every
   kernel's launch count on that path above zero.

The last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet): fp32 outside the tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
U32 = 2.0 ** -24          # unit roundoff of fp32


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> int:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches (after one warm
    call), from CUDA events."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------- kernels
def check_pairwise(torch, pw, ref, lpgf, dev, gen, rows: int, dim: int):
    m = 4096      # DPC's rho/delta row blocks: the largest call on the path
    x = torch.randn((rows, dim), generator=gen, device=dev)
    q = x[:m].contiguous()
    got = pw.pairwise_sq_l2_cuda(q, x)
    want = ref.pairwise_sq_l2(q, x)
    scale = (q * q).sum(1)[:, None] + (x * x).sum(1)[None, :]
    # worst-case fp32 error of the expansion, both sides: 4 * D * u *
    # (|q|^2 + |p|^2) (each sums D products in its own order)
    err = (got - want).abs()
    ok = bool((err <= 4 * dim * U32 * scale + 1e-6).all())
    max_err = float(err.max())
    del got, want, scale, err
    # integer grid: every sum exact in fp32, so the two must be equal
    gq = torch.randint(-3, 4, (256, dim), generator=gen, device=dev).float()
    gp = torch.randint(-3, 4, (rows, dim), generator=gen, device=dev).float()
    exact = torch.equal(pw.pairwise_sq_l2_cuda(gq, gp),
                        ref.pairwise_sq_l2(gq, gp))
    small = pw.pairwise_sq_l2_cuda(q[:17, :5].contiguous(),
                                   x[:33, :5].contiguous())
    ragged = bool(torch.allclose(small, ref.pairwise_sq_l2(q[:17, :5],
                                                           x[:33, :5]),
                                 rtol=1e-5, atol=1e-5))
    ms = time_ms(torch, lambda: pw.pairwise_sq_l2_cuda(q, x), 3)
    plain = time_ms(torch, lambda: ref.pairwise_sq_l2(q, x), 3)
    lib = time_ms(torch, lambda: torch.cdist(
        q, x, compute_mode="use_mm_for_euclid_dist"), 3)
    bms, by = bound_ms(2.0 * m * rows * dim,
                       4.0 * (m * dim + rows * dim + m * rows))
    # LPGF's call: one row chunk of a 4096-row tile against every point
    mc = lpgf._ROW_CHUNK
    qc = x[:mc].contiguous()
    chunk = dict(
        shape=f"({mc}, {rows}, {dim})",
        ms=time_ms(torch, lambda: pw.pairwise_sq_l2_cuda(qc, x), 3),
        plain_ms=time_ms(torch, lambda: ref.pairwise_sq_l2(qc, x), 3),
        library_ms=time_ms(torch, lambda: torch.cdist(
            qc, x, compute_mode="use_mm_for_euclid_dist"), 3),
        bound_ms=bound_ms(2.0 * mc * rows * dim,
                          4.0 * (mc * dim + rows * dim + mc * rows))[0])
    return (ok and exact and ragged), dict(
        name="pairwise_sq_l2", route="cuda",
        source="src/repro_torch/csrc/pairwise_l2.cu",
        replaces="src/repro/kernels/pairwise_l2.py:42",
        max_abs_err=max_err, ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib,
        shape=f"({m}, {rows}, {dim})",
        library="torch.cdist (L2, not squared)", lpgf_chunk=chunk)


def _plain_topk(torch, ref, q, x, k):
    """The plain version over 2048-row blocks (as ops.topk_l2_blocked)."""
    outs = [ref.topk_l2(q[i:i + 2048], x, k)
            for i in range(0, q.shape[0], 2048)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def check_topk_l2(torch, ft, ref, dev, gen, rows: int, dim: int):
    m, k = 4096, 2   # lpgf.mean_nn_distance: 4096 sampled rows, k=2
    # integer grid with the queries inside the point set: exact distances
    # and many exact ties, which the lower index must win
    gp = torch.randint(-3, 4, (rows, dim), generator=gen, device=dev).float()
    idx = torch.randperm(rows, generator=gen, device=dev)[:m]
    gq = gp[idx].contiguous()
    ok = True
    for mm, kk in ((m, k), (512, 256)):
        gd, gi = ft.topk_l2_cuda(gq[:mm].contiguous(), gp, kk)
        wd, wi = _plain_topk(torch, ref, gq[:mm], gp, kk)
        ok &= torch.equal(gi, wi) and torch.equal(gd, wd)
    del gp, gq
    # gaussian: distances within the fp32 error bound of the expansion
    x = torch.randn((rows, dim), generator=gen, device=dev)
    q = x[idx].contiguous()
    gd, _ = ft.topk_l2_cuda(q, x, k)
    wd, _ = _plain_topk(torch, ref, q, x, k)
    scale = (q * q).sum(1)[:, None] + (x * x).sum(1).max()
    err = (gd - wd).abs()
    ok &= bool((err <= 4 * dim * U32 * scale + 1e-6).all())
    ms = time_ms(torch, lambda: ft.topk_l2_cuda(q, x, k), 3)
    plain = time_ms(torch, lambda: _plain_topk(torch, ref, q, x, k), 2)
    lib = time_ms(torch, lambda: [torch.topk(torch.cdist(
        q[i:i + 2048], x, compute_mode="use_mm_for_euclid_dist"), k,
        largest=False) for i in range(0, m, 2048)], 2)
    bms, by = bound_ms(2.0 * m * rows * dim,
                       4.0 * (m * dim + rows * dim) + 12.0 * m * k)
    return ok, dict(
        name="topk_l2", route="cuda",
        source="src/repro_torch/csrc/fused_topk.cu",
        replaces="src/repro/kernels/fused_topk.py:83",
        max_abs_err=float(err.max()), ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, shape=f"({m}, {rows}, {dim}), k={k}",
        library="torch.cdist + torch.topk")


def check_topk_masked(torch, ft, ref, dev, gen, dim: int, k: int):
    g, c = 256, 1024   # a straggler round: 16 tiles of 64 rows
    ok = True
    gq = torch.randint(-3, 4, (g, dim), generator=gen, device=dev).float()
    gp = torch.randint(-3, 4, (g, c, dim), generator=gen, device=dev).float()
    gp[:, c // 2:] = gp[:, :c // 2]                     # duplicate points
    v = torch.rand((g, c), generator=gen, device=dev) < 0.7
    v[0] = False                                        # all masked
    v[1] = False
    v[1, :5] = True                                     # fewer than k
    d2 = ((gp - gq[:, None, :]) ** 2).sum(-1)
    lb2 = torch.where(v, 0.5 * d2, torch.full_like(d2, float("inf")))
    wd, wi = ref.topk_l2_masked(gq, gp, v, k)
    for hint in (None, lb2):
        gd, gi = ft.topk_l2_masked_cuda(gq, gp, v, k, lb2=hint)
        ok &= torch.equal(gi, wi) and torch.equal(gd, wd)
    # k > C
    sd, si = ft.topk_l2_masked_cuda(gq, gp[:, :16].contiguous(),
                                    v[:, :16].contiguous(), k)
    wsd, wsi = ref.topk_l2_masked(gq, gp[:, :16], v[:, :16], k)
    ok &= torch.equal(si, wsi) and torch.equal(sd, wsd)
    # gaussian, all valid: timing and the distance bound
    q = torch.randn((g, dim), generator=gen, device=dev)
    p = torch.randn((g, c, dim), generator=gen, device=dev)
    va = torch.ones((g, c), dtype=torch.bool, device=dev)
    gd, _ = ft.topk_l2_masked_cuda(q, p, va, k)
    wd, _ = ref.topk_l2_masked(q, p, va, k)
    scale = (q * q).sum(1)[:, None] + (p * p).sum(2).max()
    err = (gd - wd).abs()
    ok &= bool((err <= 4 * dim * U32 * scale + 1e-6).all())
    ms = time_ms(torch, lambda: ft.topk_l2_masked_cuda(q, p, va, k), 10)
    plain = time_ms(torch, lambda: ref.topk_l2_masked(q, p, va, k), 10)
    lib = time_ms(torch, lambda: torch.topk(torch.cdist(
        q[:, None, :], p)[:, 0], k, largest=False), 10)
    bms, by = bound_ms(2.0 * g * c * dim,
                       4.0 * g * c * dim + g * c + 4.0 * g * dim
                       + 12.0 * g * k)
    return ok, dict(
        name="topk_l2_masked", route="cuda",
        source="src/repro_torch/csrc/fused_topk.cu",
        replaces="src/repro/kernels/fused_topk.py:169",
        max_abs_err=float(err.max()), ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, shape=f"({g}, {c}, {dim}), k={k}",
        library="torch.cdist + torch.topk")


# -------------------------------------------------------------- main path
def hybrid_batch(Q, np, vecs, radius: float, n: int, seed: int):
    """The four paper archetypes round-robin (VK k=20, NR+VK, VR+NR,
    VR+VK), as benchmarks/bench_engine.py builds its hybrid batch."""
    rng = np.random.default_rng(seed)
    out = []
    for j, i in enumerate(rng.integers(0, len(vecs), n)):
        v = vecs[i]
        out.append([
            Q.VK.of("v", v, 20),
            Q.And.of(Q.NR("price", 25, 75), Q.VK.of("v", v, 20)),
            Q.And.of(Q.VR.of("v", v, radius), Q.NR("price", 20, 80)),
            Q.And.of(Q.VR.of("v", v, radius), Q.VK.of("v", v, 20)),
        ][j % 4])
    return out


def drive_main_path(args, dev):
    """The port's main path through the entry points a user calls:
    ``MQRLD(table).prepare()`` on a table of 12-centre Gaussian blobs
    (``args.rows`` x ``args.dim``, as benchmarks/bench_engine.py draws
    them at d=32) plus a uniform ``price`` column, then ``session()
    .plan(batch).execute()`` on the hybrid batch, once to warm and once
    timed. Returns (platform, batch, rows, stats, (prepare s, radius,
    warm s, timed s))."""
    import numpy as np
    import torch
    from repro_torch.core import query as Q
    from repro_torch.core.lake import MMOTable
    from repro_torch.core.platform import MQRLD

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(args.seed)
    centers = rng.normal(size=(12, args.dim)).astype(np.float32) * 6
    cat = rng.integers(0, 12, args.rows)
    vec = (centers[cat] + rng.normal(size=(args.rows, args.dim))
           ).astype(np.float32)
    price = rng.uniform(0, 100, args.rows).astype(np.float32)
    table = MMOTable("smoke").add_vector("v", vec).add_numeric("price",
                                                               price)
    p = MQRLD(table, seed=args.seed,
              device=None if dev.type == "cuda" else dev)
    t0 = time.time()
    p.prepare(min_leaf=64, max_leaf=1024)
    sync()
    t_prep = time.time() - t0
    # V.R radius from the data: the median 100th-nearest-neighbour
    # distance of 64 sampled rows (a fixed radius selects nothing at 512-d)
    xs = torch.as_tensor(p.table.vector["v"], device=dev)
    samp = xs[torch.as_tensor(rng.choice(args.rows, 64, replace=False),
                              device=dev)]
    d100 = torch.cdist(samp, xs).kthvalue(101, dim=1).values
    radius = float(f"{float(d100.median()):.4g}")
    del xs
    batch = hybrid_batch(Q, np, p.table.vector["v"], radius, args.batch,
                         args.seed + 1)
    sess = p.session()
    t0 = time.time()
    sess.plan(batch).execute()
    sync()
    t_warm = time.time() - t0
    t0 = time.time()
    res, stats = sess.plan(batch).execute()
    sync()
    t_exec = time.time() - t0
    return p, batch, res, stats, (t_prep, radius, t_warm, t_exec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--batch", type=int, default=256)
    args = ap.parse_args()

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail(f"no src/repro_torch beside {__file__}: run it from a "
                    f"checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the port's kernels run on the card")
    sys.path.insert(0, SRC)
    from repro_torch.core import engine, lpgf
    from repro_torch.kernels import build, fused_topk, pairwise_l2, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---------------------------------------------------------- build
    t0 = time.time()
    logs = build.build_all()
    log(f"build: {time.time() - t0:.1f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -------------------------------------------------------- kernels
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # the engine scans k plus its re-rank margin
    k_scan = min(20 + engine._RERANK_EXTRA, fused_topk.MAX_K)
    kernels = []
    for label, fn in (
            ("pairwise_sq_l2", lambda: check_pairwise(
                torch, pairwise_l2, ref, lpgf, dev, gen, args.rows,
                args.dim)),
            ("topk_l2", lambda: check_topk_l2(
                torch, fused_topk, ref, dev, gen, args.rows, args.dim)),
            ("topk_l2_masked", lambda: check_topk_masked(
                torch, fused_topk, ref, dev, gen, args.dim, k_scan))):
        ok, row = fn()
        torch.cuda.synchronize()
        log(f"kernel {label}: ok={ok} {row['shape']} ms={row['ms']:.4f} "
            f"plain_ms={row['plain_ms']:.4f} "
            f"library_ms={row['library_ms']:.4f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"max_abs_err={row['max_abs_err']:.3g}")
        if "lpgf_chunk" in row:
            log(f"kernel {label} at LPGF's chunk: "
                + json.dumps(row["lpgf_chunk"]))
        if not ok:
            return fail(f"kernel {label} disagrees with its plain version")
        kernels.append(row)
        torch.cuda.empty_cache()

    # ------------------------------------------------------ main path
    torch.cuda.reset_peak_memory_stats()
    pairwise_l2.launches = 0
    fused_topk.topk_l2_launches = 0
    fused_topk.topk_l2_masked_launches = 0
    p, batch, res, stats, times = drive_main_path(args, dev)
    t_prep, radius, t_warm, t_exec = times
    launches = {"pairwise_sq_l2": pairwise_l2.launches,
                "topk_l2": fused_topk.topk_l2_launches,
                "topk_l2_masked": fused_topk.topk_l2_masked_launches}
    log(f"prepare: {t_prep:.1f} s {p.report}")
    log(f"radius: {radius}  warm batch: {t_warm:.2f} s  timed batch: "
        f"{t_exec:.3f} s  qps: {args.batch / t_exec:.1f}")
    log("stats: " + json.dumps({k: v for k, v in vars(stats).items()
                                if k not in ("stage_samples",
                                             "knn_group_widths")}))
    stages = {}
    for kind, _, secs in stats.stage_samples:
        stages[kind] = stages.get(kind, 0.0) + secs
    log("timed batch by stage (host clock, s): " + json.dumps(
        {**stages, "other": t_exec - sum(stages.values()),
         "total": t_exec}))
    log(f"peak device memory on the main path: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("launches on the main path: " + json.dumps(launches))
    for row in kernels:
        row["launches"] = launches[row["name"]]
    if min(launches.values()) <= 0:
        return fail(f"a kernel of the main path never launched: {launches}")

    # ------------------------------------------------------- results
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        truths = list(ex.map(p.oracle, batch))
    bad = [i for i, (r, t) in enumerate(zip(res, truths))
           if not np.array_equal(r, t)]
    sizes = [len(r) for r in res]
    log(f"oracle: {time.time() - t0:.1f} s, mismatches {len(bad)} of "
        f"{len(batch)}; rows per query min {min(sizes)} max {max(sizes)}")
    if bad:
        i = bad[0]
        return fail(f"query {i} differs from the oracle: got "
                    f"{res[i][:10]} want {truths[i][:10]}")
    if any(len(res[i]) != 20 for i in range(0, len(batch), 4)):
        return fail("a top-level V.K query returned fewer than k rows")
    # why the engine re-ranks its candidates exactly: on how many
    # top-level V.K queries does the fp32 expansion order (plain version,
    # full table) differ from the oracle's exact order?
    xs = torch.as_tensor(p.table.vector["v"], device=dev)
    vk = list(range(0, len(batch), 4))
    qv = torch.as_tensor(np.stack([batch[i].vec() for i in vk]), device=dev)
    _, order = ref.stable_topk(ref.pairwise_sq_l2(qv, xs), 20)
    order = order.cpu().numpy()
    differ = sum(not np.array_equal(order[j], truths[i])
                 for j, i in enumerate(vk))
    log(f"fp32 expansion top-20 order differs from the oracle on {differ} "
        f"of {len(vk)} top-level V.K queries (the engine's certified "
        f"re-rank returns the oracle's rows on all of them; jobs that took "
        f"the widening pass in the timed batch: "
        f"{stats.knn_exact_fallbacks})")
    del xs

    log(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")}
        for row in kernels]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
