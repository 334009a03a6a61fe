#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MQRLD (``src/repro_torch``) on one card.

    python3 chip_smoke.py [--seed 0] [--rows 200000] [--dim 512]
                          [--batch 256] [--path q|r|s]

Phases, each of which fails the run (non-zero exit) on any fault:

1. build: every kernel compiled from ``src/repro_torch/csrc`` with nvcc
   (one process per source, all started together); ptxas must report no
   spill in either flash kernel (wgmma at hd 64 and 128, SIMT for fp32
   and bf16 at hd 16, 32, 64 and 128), nor in the kernels of the shared
   distance tile (``pairwise_sq_l2``, both ``topk_l2`` routes, the split
   merge) and the four of ``lpgf_force``;
2. kernels: each CUDA kernel of the retrieval paths against its plain
   PyTorch version on the card at the shapes its path gives it — ids
   exactly equal, squared distances within the fp32 dot-product error
   bound, self-distances exactly 0 on the whole Gaussian table,
   ``topk_l2`` bit-equal to ``stable_topk`` of ``pairwise_sq_l2``'s
   distances on both of its routes, ``quant_lb2``'s bounds never above
   the exact distance, ``lpgf_force``'s stored distances equal to
   ``pairwise_sq_l2``'s and its calls bit-identical — and timed beside
   its plain version, a PyTorch library yardstick and its roofline
   bound; then ``pairwise_sq_l2`` and ``topk_l2`` with NaN rows (the
   ingest path's unused delta capacity), and ``lpgf_force``'s minima,
   weights, W and F beside NaN rows, held to their plain versions: NaN
   exactly where the plain version has NaN, the same bits elsewhere
   (``check_nan_rows``);
3. fp32 path: ``MQRLD(table).prepare()`` on a 200,000 x 512 table, then
   ``session().plan(batch).execute()`` on a 256-query hybrid batch (warm,
   then timed) and one batch of V.K queries at k = 300 and 1000, every
   result row-equal to ``p.oracle(q)``;
4. mixed-precision path: ``session(precision="int8")`` and
   ``session(precision="bf16")`` on the same platform, a warm and a timed
   batch each, every row equal to the oracle's and to the fp32 rows, and
   at least one V.K job's re-rank proven without the widening pass; then
   ``quant_lb2`` held and timed again, as in phase 2, at the widest
   (G, C) each precision launched it with on this path;
   Then the planner's paths on that platform, after its timed batches:
   8 queries of each of six forms through the scalar ``MQRLD.execute``
   and a 64-query planned batch with 16 queries the engine cannot plan
   (``explain()["n_scalar"]`` 16), every row the oracle's; 64 V.K
   queries through ``BatchedExecutor`` on the card and ``HostExecutor``,
   each the brute force's rows; Algorithm 3 (``optimize_index``) on a
   skewed workload, the scalar path's rows and work unchanged; and
   ``calibrate(batch=16)``, then the hybrid batch again under the fitted
   model, every row the oracle's;
   Then ingest on that platform (``drive_ingest_path``): 3 appends of
   5,000 rows (15,000 in a delta capacity of 16,384, so 1,384 NaN pad
   rows), each followed by ``sync_delta`` and the hybrid batch on the
   fp32 device loop, every row equal to the oracle's over ``view()``
   (all 256 queries after the first and last append, 64 after the
   others); after the last the host loop, int8 and bf16 too; then
   ``fold()``, the engines rebuilt, and the batch on both loops and in
   all three precisions; append, sync, batch, fold and rebuild times;
   Then persistence on that platform (``drive_persist_path``, path
   (h)): ``default_precision = "int8"``, 2,500 rows appended (a live
   delta), ``save_platform`` into a temporary directory and
   ``load_platform``; the loaded int8 engine must take the persisted
   planes (no base layout quantized, its planes the loaded arrays,
   equal to the live engine's bit for bit); the batch on the loaded
   platform in fp32 and int8 row-equal to the live platform's, its first
   64 queries to the oracle's; the enqueue half of the engine's dispatch
   under ``set_sync_debug_mode("error")`` in fp32 and int8; save, load
   and engine seconds and the bytes on disk;
   Then sharded execution on the live platform (``drive_sharded_path``,
   path (o)), uncalibrated: ``session(shards=S)`` at S = 1, 2 and 8 in
   fp32 and S = 8 in int8, each engine derived from the single-device
   one, the hybrid batch warm and timed: every row equal to the live
   platform's single-device rows of that precision, ids and order (or
   shown to differ only by an exact tie at the k-th distance), the
   first 64 to the oracle, ``stats.shards`` S; in fp32 a 16-query V.R
   batch around one row through the sharded V.R tile route, its rows the
   single-device loop's and the oracle's; engine build and batch
   seconds by S and the peak device memory;
   Then retrieval serving on the loaded platform
   (``drive_serving_path``, path (i)): ``RetrievalServer(batch_size=64)``
   with ``EmbeddingServer(mqrld-embedder-100m)`` at full size in bf16 (on
   its own stream) and a seeded 768 -> 512 projection, 384 requests
   (prompts of 16, 32, 64 and 128 tokens; V.K k = 20, V.K k = 100 and
   N.R + V.K k = 20 in turn) at pipeline depth 1 in fp32 and at depth 1
   and 3 in int8: rows identical request by request, 128 sampled
   requests equal to the oracle of their own query; then 64 prompts
   appended by token and served, each answered by its own row first;
   requests per second, per-chunk stage seconds and a traced depth-3
   window of 192 requests;
   Then online re-optimization on (h)'s live platform
   (``drive_reopt_path``, path (j)): ``RetrievalServer(batch_size=64)``
   in fp32 with (i)'s embedder, ``fold_mode = "background"``, 2,500 rows
   appended (fold due), and a ``ReoptController`` attached: its first
   steps between micro-batches build, warm and swap a fold generation of
   220,000 rows; then it tunes the transform on 1,024-row shadows,
   builds the winner's generation at full size beside the serving one,
   warms it (a second engine on the card) and swaps it (or, when the
   tuner finds no improvement, the path builds, warms and swaps the best
   candidate's generation itself: one full-size build either way); 256
   rows appended, then ``rollback()`` in memory. 32 served requests held
   to the oracle by logical row identity before the fold swap, after
   it, after the re-optimizing swap, and after the append and the
   rollback; no warm-up error; the first batch after the swap a
   plan-cache hit on the prewarmed engine; seconds by step kind, the
   longest stall, requests per second and the peak device memory;
5. small-table path: ``prepare()`` with its defaults on a 4,096-row
   table (LPGF's force kernel), then a 64-query batch, every row equal to
   the oracle's; then generations on it (``drive_rollback``): two saves
   around an append and fold, ``rollback_platform`` and
   ``MQRLD.rollback()``, each giving the first generation's rows, and
   ``CURRENT`` flipped back;
6. embedding path: ``EmbeddingServer(mqrld-embedder-100m)`` at full size
   on 64 token rows of 128, (64, 768) and finite, and 4 rows again on the
   CPU with the same weights (``drive_embedding_path`` states the
   tolerance);
7. generation path: ``ServeEngine(llama3-8b)`` at full width and 32
   layers on prompts of 2048, 2048, 1000 and 1000 tokens, 16 new tokens
   each: the flash kernel held to its plain version on every layer of
   every real prefill, each of those launches on the wgmma kernel, the
   prefill against the dense forward, batched against per-request
   generation; init, prefill and decode times and the peak device memory
   (``drive_generation_path``);
8. fp32 generation path: ``ServeEngine`` on reduced llama3-8b in fp32
   (the SIMT flash kernel's route: every fp32 input, and bf16 at hd 16
   and 32) on prompts of 1000, 1000, 300 and 40 tokens: every flash
   launch held to its plain version and on the SIMT kernel, tokens equal
   to the CPU's;
9. olmo-1b fp32 serving path: ``ServeEngine(olmo-1b)`` in fp32, its
   published type, at full width and ``OLMO_LAYERS`` (8) of its 16
   layers (cut for the time limit) on prompts of 2032, 2032, 1000 and
   1000 tokens, 16 new tokens each: the SIMT kernel held to its plain
   version on all 16 layers of the real prefills, batched
   against per-request generation; init, prefill and decode times, the
   peak device memory and a traced prefill (``drive_olmo_fp32_path``);
10. MoE serving path (k): ``ServeEngine`` in bf16 at full width on
   phi3.5-moe-42b-a6.6b at 8 of its 32 layers (all 32 do not fit
   beside the cache; 24 do, cut to 8 for the time limit) on prompts of
   2048, 2048, 1000 and 1000 tokens, 16 new tokens each, then on
   arctic-480b at 2 of its
   35 layers (51.8 GiB; 128 experts, the dense residual branch) on two
   prompts of 1000 tokens, 8 new each: every flash launch of every real
   prefill held to its plain version and on the wgmma kernel, the
   prefill against the dense forward, batched against per-request
   generation, the dropped share of (token, choice) pairs per layer, and
   one layer's ``moe`` against the reference's one-hot formulation in
   plain torch (``moe_onehot``) on the same input: routing identical,
   outputs within 2^-8 of their scale; init, prefill and decode times,
   the peak device memory and a traced prefill (``drive_moe_path``);
11. hymba serving path (l): ``ServeEngine(hymba-1.5b)`` at full width
   and depth in bf16 on two prompts of 1,152 tokens, 16 new tokens each:
   the stream forward's 32 flash launches (28 windowed at 1024, 4
   global, all on the wgmma kernel at hd 64) held to the plain version;
   the prompt replayed through decode to fill the ring buffers (each
   wraps); the last prompt position's logits of the stream forward
   against the replay's and the dense windowed forward's; the replay's
   seconds per step and a traced decode step (``drive_hymba_path``);
12. xlstm serving path (m): ``ServeEngine(xlstm-1.3b)`` at full width
   and depth in bf16 (48 blocks: 6 groups of 7 mLSTMs and 1 sLSTM) on
   prompts of 2048, 2048, 1024 and 1024 tokens, 16 new each, its
   prefill returning the filled recurrent state: batched against
   per-request generation; layer 0's chunked mLSTM against its
   recurrence and chunk 64 against 16 in fp32, beside the exact (fp64)
   result; the prefill against the train-mode forward, a decode step
   after it against the forward over the prompt and that token; the
   state's bytes, the sLSTM scans' share of a prefill and a traced
   prefill (``drive_xlstm_path``);
13. enc-dec serving path (n): ``ServeEngine(seamless-m4t-medium)`` at
   full width and depth in bf16 (12 + 12 layers, 4,096 frames) on
   prompts of 768, 768, 512 and 512 tokens, 16 new each, on zero
   frames: every stream-prefill flash launch (the decoder's
   self-attention) held and on the wgmma kernel, batched against
   per-request generation; then on Gaussian frames the cross cache
   against the encoder's K/V, the stream forward's last logits against
   the prompt's replay and the dense forward, and against the
   zero-frame run's (the cross-attention reached); zero-frame embedding
   rows all equal (``drive_encdec_path``);
14. training path (p): ``mqrld-embedder-100m`` trained at full size
   through ``train()`` (bf16 compute, fp32 masters, block remat; 20
   steps of 16 x 512 tokens in two microbatches): one step's loss and
   gradient held to fp64 and AdamW on the card held to the CPU bit for
   bit (``check_train_numerics``), the loss falling, the step-10
   checkpoint restored equal to what was saved, a resume to step 24, 3
   steps in int8 state; then the trained embedder feeds
   ``MQRLD(...).prepare()`` over the example's 2,000 documents and 64
   hybrid queries return the oracle's rows; step seconds, tokens/s,
   MFU and peak memory (``drive_train_path``);
15. family training path (q): xlstm-1.3b whole (48 blocks), hymba-1.5b
   at 8 of 32 layers (one group: 7 windowed + 1 global, seq 1152 past
   its 1,024 window) and seamless-m4t-medium at 2 + 2 of 12 + 12 layers
   (4,096 Gaussian frames), each at full width, bf16 compute, fp32
   masters, block remat, one after the other: the bf16 loss at the init
   masters within 2^-7 of fp64's; every fp32 gradient leaf within 1e-3
   RMS of fp64's one group deep with q and k tempered; xlstm's graphed
   ``SLSTMScan`` against its step-by-step run (bit for bit); 3 steps of
   ``make_train_step``, the last loss below the first (xlstm and enc-dec
   from tempered masters: at the init law xlstm's gradient norm overflows
   and enc-dec's loss rises); xlstm's checkpoint (int8 AdamW state)
   saved and restored equal; step seconds, tokens/s, MFU and peak
   memory. Then the compressed cross-pod step
   (``make_compressed_train_step`` over ``pod_mesh(2)``) on the embedder
   at full size against one plain step (loss within 0.05, parameters
   within 1e-2), and 3 more steps with per-pod error buffers
   (``drive_family_train_path``); no kernel of the port launches;
16. build options (b) and the dry-run path (r) (``run_dryrun_paths``;
   ``--path r`` builds and runs these alone): HIBOG on 4,096 x 512 grid
   points on the ``topk_l2`` kernel (neighbour ids the plain version's,
   moved points the CPU's), ``build_index(split_lpgf=True)`` on 4,096 x
   512 blobs (a valid tree, queries the oracle's, compared with the
   CPU's tree built beside); then llama3-8b at 2 of 32 layers, train
   and prefill (``DRY_CELLS``), each predicted by ``launch/dryrun.py``
   on fake tensors and run on the card (``drive_dry_cell``'s four
   checks), and the full-size cells ``DRY_FULL`` traced on the CPU
   beside them;
17. the examples (s) (``run_examples_path``; ``--path s`` builds and
   runs it alone): each of the port's seven examples
   (``repro_torch.examples``) and ``scripts/smoke_models`` through its
   ``main(["--device", "cuda", ...])`` in this process (the quickstart's
   lake in a temporary directory, ``train_embedder`` at the published
   width, ``EXAMPLE_TRAIN``), the launch counters reset before each:
   every row it answers equal, as a set, to the brute force over its raw
   columns (``oracle_misses``), rows identical across precisions, depths
   and shard counts, exact through the tuner's swap, the background fold
   and the rollback, the embedder's loss falling, every reduced config
   finite, and each example's kernels (``EXAMPLE_KERNELS``) launched;
   one line each with its seconds, launches, figures and peak memory;
18. ``flash_attention`` against its plain version, each kernel at its
   widest path launch (the kernels JSON rows: llama3-8b's bf16 prefill
   on wgmma, olmo-1b's fp32 prefill on SIMT), at path 8's shape, at the
   llama prefill's shape on both kernels (the SIMT one launched by name
   on the same bf16 inputs) and in fp32, at the new paths' shapes
   (arctic's 64 padded heads, hymba's windowed and global layers,
   seamless-m4t-medium's decoder: rows of their own in the kernels
   JSON, with their path's launches), and at
   ``FLASH_CASES`` (bf16 at hd 64 and 128 on both kernels), timed on the
   card and on the host beside its plain version,
   ``scaled_dot_product_attention`` (on a boolean mask where there is a
   window; with the backend it took at the path shapes) and its bound.

Each path's kernels must have launched in that path's run (counts set to
0 just before it, read just after); the embedding and xlstm paths run
none, the training path ``pairwise_sq_l2`` and ``topk_l2_masked``
through its platform, the family training path none (it fails if any
launches). ``--path q``, ``r`` or ``s`` builds and runs that path alone,
and prints no result line. The
last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

U32 = 2.0 ** -24          # unit roundoff of fp32


def log(*a):
    print(*a, flush=True)


def fail(msg: str) -> int:
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def bound_ms(flops: float, nbytes: float, dtype: str = "fp32"):
    """The least time the card could take (ms): the larger of the
    operations over the peak for their type and the bytes over the
    memory rate, from the one peak table the cost model reads too
    (``repro_torch.utils.roofline``), and which of the two bounds it."""
    from repro_torch.utils.roofline import PEAK_BYTES, peak_flops
    t_ops, t_bytes = flops / peak_flops(dtype), nbytes / PEAK_BYTES
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
def _pairwise_call(torch, pw, ref, x, mc: int):
    """Time ``pairwise_sq_l2`` at (mc, rows, dim), the first mc rows of x
    against all of them, beside its plain version, ``torch.cdist`` and
    its bound."""
    rows, dim = x.shape
    qc = x[:mc].contiguous()
    return dict(
        shape=f"({mc}, {rows}, {dim})",
        ms=time_ms(torch, lambda: pw.pairwise_sq_l2_cuda(qc, x), 3),
        plain_ms=time_ms(torch, lambda: ref.pairwise_sq_l2(qc, x), 3),
        library_ms=time_ms(torch, lambda: torch.cdist(
            qc, x, compute_mode="use_mm_for_euclid_dist"), 3),
        bound_ms=bound_ms(2.0 * mc * rows * dim,
                          4.0 * (mc * dim + rows * dim + mc * rows))[0])


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
    # self-distances exactly 0: the first m rows against the table, then
    # every row of the table against itself, 4096 rows a call
    self_zero = bool((got.diagonal() == 0).all())
    del got, want, scale, err
    for i in range(0, rows, m):
        xb = x[i:i + m].contiguous()
        self_zero &= bool((pw.pairwise_sq_l2_cuda(xb, xb).diagonal() == 0)
                          .all())
    log(f"pairwise_sq_l2: self-distances exactly 0 on all {rows} Gaussian "
        f"rows: {self_zero}")
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
    row = _pairwise_call(torch, pw, ref, x, m)
    bms, by = bound_ms(2.0 * m * rows * dim,
                       4.0 * (m * dim + rows * dim + m * rows))
    return (ok and exact and ragged and self_zero), dict(
        name="pairwise_sq_l2", route="cuda",
        source="src/repro_torch/csrc/pairwise_l2.cu",
        replaces="src/repro/kernels/pairwise_l2.py:42",
        max_abs_err=max_err, ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=bms, bound_by=by, library_ms=row["library_ms"],
        shape=row["shape"], library="torch.cdist (L2, not squared)",
        # LPGF's call (one row chunk of a 4096-row tile against every
        # point) and the dense V.R mask's (a 256-query batch)
        lpgf_chunk=_pairwise_call(torch, pw, ref, x, lpgf._ROW_CHUNK),
        vr_dense=_pairwise_call(torch, pw, ref, x, 256))


def _nan_equal(torch, a, b) -> bool:
    """Equal values, and NaN in the same places."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def check_nan_rows(torch, pw, ft, lf, ref, dev, gen, rows: int, dim: int,
                   capacity: int = 32768, live: int = 20000):
    """``pairwise_sq_l2`` with NaN rows, at the dense V.R pass's shape on
    the ingest path before its cut to 3 appends: a 256-query batch
    against the base rows plus a delta of ``capacity`` rows of which
    ``live`` hold data and the rest are NaN, one query row NaN and one
    point NaN in one coordinate. On an integer grid (every sum exact)
    the kernel must give NaN exactly where
    the plain version does and its bits everywhere else; on Gaussian
    inputs the entries off the NaN rows must equal the kernel's output
    without them, bit for bit. ``topk_l2`` on the same grid and on 40
    points of which 15 are NaN, k = 40: NaN rows rank last, ids and
    distances the plain version's. ``lpgf_force`` on 1,000 Gaussian
    points with the same NaN rows (``lpgf_nan_rows``): its per-tile
    minima equal ``torch.amin`` over its own stored distances (NaN in the
    same places, the same bits elsewhere), its weights the plain law's
    on them bit for bit, W and F NaN where the plain formula's are.
    Returns (ok, info)."""
    n = rows + capacity
    pad = list(range(rows + live, n))
    info = {"shape": f"(256, {n}, {dim})", "nan_point_rows": len(pad) + 1,
            "nan_query_rows": 1}

    def with_nan(x, full, one):
        x[full] = float("nan")
        x[one, dim // 2] = float("nan")
        return x
    gq = with_nan(torch.randint(-3, 4, (256, dim), generator=gen,
                                device=dev).float(), [7], 200)
    gp = with_nan(torch.randint(-3, 4, (n, dim), generator=gen,
                                device=dev).float(), pad, rows + 5)
    got = pw.pairwise_sq_l2_cuda(gq, gp)
    want = ref.pairwise_sq_l2(gq, gp)
    info["grid_equal_to_plain"] = _nan_equal(torch, got, want)
    info["nan_entries"] = int(torch.isnan(got).sum())
    info["ms"] = time_ms(torch, lambda: pw.pairwise_sq_l2_cuda(gq, gp), 3)
    info["plain_ms"] = time_ms(torch, lambda: ref.pairwise_sq_l2(gq, gp), 3)
    topk = True
    for k in (2, 300):
        gd, gi = ft.topk_l2_cuda(gq, gp, k)
        wd, wi = ref.topk_l2(gq, gp, k)
        topk &= torch.equal(gi, wi) and _nan_equal(torch, gd, wd)
    small = with_nan(gp[:40].clone(), list(range(0, 40, 3)), 38)
    gd, gi = ft.topk_l2_cuda(gq[:64].contiguous(), small, 40)
    wd, wi = ref.topk_l2(gq[:64], small, 40)
    topk &= torch.equal(gi, wi) and _nan_equal(torch, gd, wd) and bool(
        torch.isnan(gd[:, -15:]).all())
    info["topk_l2_equal_to_plain"] = topk
    del gq, gp, got, want
    q = with_nan(torch.randn((256, dim), generator=gen, device=dev), [7], 200)
    p = with_nan(torch.randn((n, dim), generator=gen, device=dev), pad,
                 rows + 5)
    got = pw.pairwise_sq_l2_cuda(q, p)
    qok, pok = ~torch.isnan(q).any(1), ~torch.isnan(p).any(1)
    clean = pw.pairwise_sq_l2_cuda(q[qok].contiguous(), p[pok].contiguous())
    info["gaussian_bits_unchanged"] = torch.equal(got[qok][:, pok], clean)
    info["gaussian_nan_rows_all_nan"] = bool(
        torch.isnan(got[~qok]).all() and torch.isnan(got[:, ~pok]).all())
    del q, p, got, clean
    info["lpgf_nan_rows"] = lpgf_nan_rows(torch, lf, ref, dev, gen, dim)
    ok = (info["grid_equal_to_plain"] and topk
          and info["gaussian_bits_unchanged"]
          and info["gaussian_nan_rows_all_nan"]
          and all(info["lpgf_nan_rows"].values()))
    return ok, info


def lpgf_nan_rows(torch, lf, ref, dev, gen, dim: int, n: int = 1000):
    """``lpgf_force`` through ``lf._launch(keep=True)`` on ``n`` Gaussian
    points of which two rows are NaN and one is NaN in one coordinate,
    at a radius of 7.5 mean neighbour distances: {check: passed}."""
    x = torch.randn((n, dim), generator=gen, device=dev)
    d2 = ref.pairwise_sq_l2(x, x)
    d2.fill_diagonal_(float("inf"))
    g = float(d2.min(1).values.sqrt().mean())
    x[[5, n // 2]] = float("nan")
    x[n - 3, dim // 2] = float("nan")
    gf, gw, s = lf._launch(x, 7.5 * g, g, keep=True)
    off = s["d2"].clone()
    off.fill_diagonal_(float("inf"))
    t = -(-n // lf.TILE)
    minima = torch.nn.functional.pad(
        off, (0, t * lf.TILE - n), value=float("inf")).view(
            n, t, lf.TILE).amin(2)
    want_w, want_d1 = ref.lpgf_weights(s["d2"], 7.5 * g, g)
    wf, ww = ref.lpgf_force(x, 7.5 * g, g, d2=s["d2"])
    return dict(
        minima_equal_plain=_nan_equal(torch, s["pmin"], minima),
        minima_nan_and_finite=bool(torch.isnan(minima).any())
        and bool(torch.isfinite(minima).any()),
        d1_equal_plain=_nan_equal(torch, s["pmin"].min(1).values, want_d1),
        weights_equal_plain=_nan_equal(torch, s["w"], want_w),
        w_nan_where_plain=torch.equal(torch.isnan(gw), torch.isnan(ww))
        and bool(torch.isnan(ww).any()),
        f_nan_where_plain=torch.equal(torch.isnan(gf), torch.isnan(wf)))


def check_topk_l2(torch, ft, pw, ref, build, dev, gen, rows: int, dim: int):
    """``topk_l2`` at the path's launch, (2048, rows, dim) with k = 2
    (``lpgf.mean_nn_distance`` through ``ops.topk_l2_blocked``, launched
    twice on the fp32 path), on its register route; the rank-merge route
    at k = 17, 256, 300 and 1000; both against the plain version."""
    m, k = 2048, 2
    # integer grid with the queries inside the point set: exact distances
    # and many exact ties, which the lower index must win
    gp = torch.randint(-3, 4, (rows, dim), generator=gen, device=dev).float()
    idx = torch.randperm(rows, generator=gen, device=dev)[:m]
    gq = gp[idx].contiguous()
    grid_ok = True
    for mm, kk in ((m, k), (512, 256), (256, 300), (128, 1000)):
        gd, gi = ft.topk_l2_cuda(gq[:mm].contiguous(), gp, kk)
        wd, wi = ref.topk_l2(gq[:mm], gp, kk)
        grid_ok &= torch.equal(gi, wi) and torch.equal(gd, wd)
    # each of 8 query rows copied into every N split: exact ties across
    # splits, which the lower index must win in any merge order
    for kk in (2, 300):
        splits = build.library("fused_topk").topk_l2_splits(
            m, rows, kk, int(ft.route(kk) == "reg"))
        for j in range(8):
            for b, e in ft.split_bounds(rows, splits):
                gp[min(e - 1, b + 11 + j)] = gq[j]
        gd, gi = ft.topk_l2_cuda(gq, gp, kk)
        wd, wi = ref.topk_l2(gq, gp, kk)
        grid_ok &= torch.equal(gi, wi) and torch.equal(gd, wd)
        log(f"topk_l2: ties across {splits} splits at k={kk}: "
            f"{torch.equal(gi, wi)}")
    del gp, gq
    # gaussian: ids and distances equal stable_topk of the pairwise
    # kernel's distances bit for bit (one tile), distances within the
    # fp32 error bound of the plain version's; both routes at k = 2
    x = torch.randn((rows, dim), generator=gen, device=dev)
    q = x[idx].contiguous()
    same = True
    for mm, kk in ((m, 1), (m, 2), (512, 17), (512, 256), (256, 300),
                   (128, 1000)):
        qm = q[:mm].contiguous()
        gd, gi = ft.topk_l2_cuda(qm, x, kk)
        wd, wi = ref.stable_topk(pw.pairwise_sq_l2_cuda(qm, x), kk)
        same &= torch.equal(gi, wi) and torch.equal(gd, wd)
    md, mi = ft._launch(q, x, k, "merge")
    gd, gi = ft.topk_l2_cuda(q, x, k)
    routes = torch.equal(md, gd) and torch.equal(mi, gi)
    self_first = bool((gi[:, 0] == idx).all())
    wd, _ = ref.topk_l2(q, x, k)
    scale = (q * q).sum(1)[:, None] + (x * x).sum(1).max()
    err = (gd - wd).abs()
    bounded = bool((err <= 4 * dim * U32 * scale + 1e-6).all())
    log(f"topk_l2: integer grid equal to the plain version {grid_ok}; "
        f"Gaussian equal to stable_topk(pairwise_sq_l2_cuda) bit for bit "
        f"at k = 1, 2, 17, 256, 300, 1000: {same}; register and rank-merge "
        f"routes equal at k=2: {routes}; each query's first hit itself: "
        f"{self_first}; within the fp32 bound of the plain version: "
        f"{bounded}")
    ms = time_ms(torch, lambda: ft.topk_l2_cuda(q, x, k), 3)
    plain = time_ms(torch, lambda: ref.topk_l2(q, x, k), 2)
    lib = time_ms(torch, lambda: torch.topk(torch.cdist(
        q, x, compute_mode="use_mm_for_euclid_dist"), k, largest=False), 2)
    merge_ms = time_ms(torch, lambda: ft._launch(q, x, k, "merge"), 2)
    bms, by = bound_ms(2.0 * m * rows * dim,
                       4.0 * (m * dim + rows * dim) + 12.0 * m * k)
    return (grid_ok and same and routes and self_first and bounded), dict(
        name="topk_l2", route="cuda",
        source="src/repro_torch/csrc/fused_topk.cu",
        replaces="src/repro/kernels/fused_topk.py:83",
        max_abs_err=float(err.max()), ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, shape=f"({m}, {rows}, {dim}), k={k}",
        library="torch.cdist + torch.topk", merge_route_ms=merge_ms)


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
    # k above the old 256 limit, ids exact (and distances: exact sums)
    for kk in (300, 1000):
        for hint in (None, lb2):
            bd, bi = ft.topk_l2_masked_cuda(gq, gp, v, kk, lb2=hint)
            wbd, wbi = ref.topk_l2_masked(gq, gp, v, kk)
            ok &= torch.equal(bi, wbi) and torch.equal(bd, wbd)
    # gaussian, all valid: timing and the distance bound
    q = torch.randn((g, dim), generator=gen, device=dev)
    p = torch.randn((g, c, dim), generator=gen, device=dev)
    va = torch.ones((g, c), dtype=torch.bool, device=dev)
    gd, _ = ft.topk_l2_masked_cuda(q, p, va, k)
    wd, _ = ref.topk_l2_masked(q, p, va, k)
    scale = (q * q).sum(1)[:, None] + (p * p).sum(2).max()
    err = (gd - wd).abs()
    ok &= bool((err <= 4 * dim * U32 * scale + 1e-6).all())
    # 5 rounds of 10 launches, the median in the row: single samples of
    # this shape once spread by 2x between calls on an H100
    rounds = sorted(time_ms(torch, lambda: ft.topk_l2_masked_cuda(
        q, p, va, k), 10) for _ in range(5))
    ms = rounds[2]
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
        library="torch.cdist + torch.topk", rounds_ms=rounds)


def _row_chunks(g: int, c: int, dim: int, elems: int = 2 ** 27):
    """Query ranges whose (rows, c, dim) temporaries hold about ``elems``
    elements (1 GiB in fp64), for the plain version and the exact check
    at the widest rounds."""
    b = max(1, elems // max(1, c * dim))
    return [(i, min(g, i + b)) for i in range(0, g, b)]


def _quant_inputs(torch, plan_tiles, dev, gen, dim: int, precision: str,
                  g: int, c: int):
    """A mixed-precision round of ``g`` queries x ``c`` candidates (tiles
    of 64 rows, each query's tiles drawn without repeats), with an
    all-masked row, an all-zero tile (the int8 scale floors), a constant
    tile and duplicate rows. Returns the kernel's operands, the fp32
    tiles and the selection, from which the exact distances follow."""
    cap = 64
    w = -(-c // cap)
    t = max(64, w)
    tiles = torch.randn((t, cap, dim), generator=gen, device=dev) * 4
    tiles[3] = 0.0
    tiles[4] = 2.5
    tiles[1] = tiles[0]                                  # duplicate rows
    tv = torch.ones((t, cap), dtype=torch.bool, device=dev)
    tv[-1, 40:] = False
    sel = torch.argsort(torch.rand((g, t), generator=gen, device=dev),
                        dim=1)[:, :w]
    sel[:, 0] = torch.arange(g, device=dev) % 5          # the edge tiles
    q = torch.randn((g, dim), generator=gen, device=dev) * 4
    if g > 1:
        q[1] = tiles[sel[1, 0], 5]                       # distance 0
    v = (torch.rand((g, c), generator=gen, device=dev) < 0.8) \
        & tv[sel].reshape(g, w * cap)[:, :c]
    v[0] = False                                         # all masked
    if g > 2:
        v[2, 100:] = False
    pl = plan_tiles(tiles.cpu().numpy(), tv.cpu().numpy(), precision)
    pl = [x.to(dev) for x in pl]
    codes = pl[0][sel].reshape(g, w * cap, dim)[:, :c].contiguous()
    cs = pl[1][sel].repeat_interleave(cap, 1)[:, :c].contiguous()
    cp = pl[2][sel].reshape(g, w * cap)[:, :c].contiguous()
    ce = pl[3][sel].repeat_interleave(cap, 1)[:, :c].contiguous()
    return (q, codes, cs, cp, ce, v.contiguous()), tiles, sel


def check_quant_lb2(torch, qk, ref, build, plan_tiles, dev, gen, dim: int,
                    precision: str, g: int = 256, c: int = 1024):
    """``quant_lb2`` at (g, c, dim): bounds against the plain version
    (int8 bit for bit, bf16 within its cross term's summation order),
    +inf exactly where invalid, and no bound above the exact (fp64)
    squared distance. Times the wrapper (which quantizes the query with
    a few torch operations first), the kernel's own launch on the
    pre-quantized operands, the plain version and, for bf16, a bf16
    ``bmm`` with the elementwise epilogue."""
    from repro_torch.utils.quant import quantize_query
    args, tiles, sel = _quant_inputs(torch, plan_tiles, dev, gen, dim,
                                     precision, g, c)
    q, codes, cs, cp, ce, v = args
    chunks = _row_chunks(g, c, dim)

    def plain():
        return torch.cat([ref.quant_lb2(*(x[a:b] for x in args),
                                        precision=precision)
                          for a, b in chunks])
    got = qk.quant_lb2_cuda(*args, precision=precision)
    want = plain()
    ok = torch.equal(torch.isinf(got), ~v)
    mag = ((q * q).sum(1)[:, None] + cp).clamp_min(0)
    err = (got - want).abs()[v]
    if precision == "int8":   # exact integer cross term, same epilogue
        ok &= torch.equal(got, want)
    else:                     # the cross term's sum order
        ok &= bool((err <= 1e-3 * mag.sqrt()[v]).all())
    del want, mag
    # the conservative-bound contract against the exact distance (fp64)
    violations = 0
    for a, b in chunks:
        pts = tiles[sel[a:b]].reshape(b - a, -1, dim)[:, :c].double()
        exact = ((pts - q[a:b, None, :].double()) ** 2).sum(-1)
        del pts
        violations += int((got[a:b].double()[v[a:b]]
                           > exact[v[a:b]]).sum())
        del exact
    ok &= violations == 0
    del tiles, sel
    # the kernel alone, on operands quantized beforehand
    qc, qscale, qqq, qeps = (t.contiguous()
                             for t in quantize_query(q, precision))
    lib = build.library("quant_lb2")
    out = torch.empty_like(got)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def kernel():
        build.check(lib.quant_lb2_launch(
            qc.data_ptr(), qscale.data_ptr(), qqq.data_ptr(),
            qeps.data_ptr(), codes.data_ptr(), cs.data_ptr(), cp.data_ptr(),
            ce.data_ptr(), v.data_ptr(), out.data_ptr(), g, c, dim,
            int(precision == "int8"), stream), "quant_lb2")
    kernel()
    torch.cuda.synchronize()
    ok &= torch.equal(out, got)
    ms = time_ms(torch, lambda: qk.quant_lb2_cuda(*args, precision=precision),
                 20)
    kernel_ms = time_ms(torch, kernel, 20)
    plain_ms = time_ms(torch, plain, 5)
    qprep = time_ms(torch, lambda: quantize_query(q, precision), 20)
    lib_ms = None
    if precision == "bf16":
        # one bf16 bmm for the cross terms plus the elementwise epilogue
        def library():
            qb, _, qn, qe = quantize_query(q, "bf16")
            cross = torch.bmm(codes, qb[:, :, None])[:, :, 0].float()
            d2h = (qn[:, None] + cp - 2.0 * cross).clamp_min(0)
            dh = d2h.sqrt()
            lbr = (dh - (qe[:, None] + ce) - (1e-4 + 1e-4 * dh + 2e-3 * (
                qn[:, None] + cp).clamp_min(0).sqrt())).clamp_min(0)
            return torch.where(v, lbr * lbr, float("inf"))
        lib_ms = time_ms(torch, library, 20)
    esz = 1 if precision == "int8" else 2
    nvalid = int(v.sum())
    # bytes the function must move: the valid candidates' codes and
    # metadata (scale, norm, error: 12 bytes), every candidate's validity
    # byte and output, and the query
    bms, by = bound_ms(2.0 * nvalid * dim,
                       esz * (nvalid * dim + g * dim) + 12.0 * nvalid
                       + 5.0 * g * c + 16.0 * g, precision)
    return ok, dict(
        name="quant_lb2", route="cuda",
        source="src/repro_torch/csrc/quant_lb2.cu",
        replaces="src/repro/kernels/fused_topk.py:283",
        max_abs_err=float(err.max()) if err.numel() else 0.0, ms=ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
        violations=violations, kernel_ms=kernel_ms,
        query_quantize_ms=qprep, shape=f"({g}, {c}, {dim}) {precision}",
        library="torch.bmm in bf16 + epilogue" if lib_ms else "none")


def check_lpgf_force(torch, lf, pw, ref, dev, gen, dim: int):
    """Quarter-integer points make every squared distance exact, so the
    kernel and the plain version take the same ring decisions; F agrees
    within 1e-5 of its largest entry and W within rtol 1e-5 (sum order):
    at (4096, dim), (1000, dim), (1000, 37) (D not a multiple of 4: the
    4-byte copies) and (1000, 2048) (past the old shared-memory limit).
    Then on Gaussian points at (4096, dim), through ``lf._launch(keep=
    True)``: the stored squared distances symmetric and equal to
    ``pairwise_sq_l2_cuda(x, x)`` bit for bit, d1 (the least of the
    per-tile row minima) the least distance off the diagonal, the weights
    the plain law's on those distances bit for bit, F and W within the
    same tolerances of the plain formula fed those distances; and two
    calls bit-identical."""
    ok, errs = True, []

    def held(x, r, g, gf, gw, d2=None):
        wf, ww = ref.lpgf_force(x, r, g, d2=d2)
        scale = float(wf.abs().max()) + 1e-6
        errs.append(float((gf - wf).abs().max()))
        return (errs[-1] <= 1e-5 * scale and
                bool(((gw - ww).abs() <= 1e-5 + 1e-5 * ww.abs()).all()))

    for n, d in ((4096, dim), (1000, dim), (1000, 37), (1000, 2048)):
        x = torch.randint(-12, 13, (n, d), generator=gen,
                          device=dev).float() * 0.25
        x[7] = x[3]                                       # a duplicate
        d2 = ref.pairwise_sq_l2(x, x)
        d2.fill_diagonal_(float("inf"))
        g = float(d2.min(1).values.sqrt().mean())
        del d2
        gf, gw = lf.lpgf_force_cuda(x, 7.5 * g, g)
        ok &= held(x, 7.5 * g, g, gf, gw)
        if (n, d) == (4096, dim):
            xt, rt, gt = x, 7.5 * g, g
    n = xt.shape[0]
    xg = torch.randn((n, dim), generator=gen, device=dev)
    xg[7] = xg[3]
    d2 = ref.pairwise_sq_l2(xg, xg)
    d2.fill_diagonal_(float("inf"))
    gg = float(d2.min(1).values.sqrt().mean())
    del d2
    gf, gw, s = lf._launch(xg, 1.5 * gg, gg, keep=True)
    d2 = s["d2"]
    off = d2.clone()
    off.fill_diagonal_(float("inf"))
    want_w, want_d1 = ref.lpgf_weights(d2, 1.5 * gg, gg)
    stored = dict(
        symmetric=torch.equal(d2, d2.T),
        equals_pairwise=torch.equal(d2, pw.pairwise_sq_l2_cuda(xg, xg)),
        d1_is_row_min=torch.equal(s["pmin"].min(1).values,
                                  off.min(1).values),
        weights_equal_plain=torch.equal(s["w"], want_w)
        and torch.equal(off.min(1).values, want_d1),
        held_to_own_d2=held(xg, 1.5 * gg, gg, gf, gw, d2=d2))
    del s, d2, off, want_w
    a = lf.lpgf_force_cuda(xg, 1.5 * gg, gg)
    b = lf.lpgf_force_cuda(xg, 1.5 * gg, gg)
    stored["calls_bit_identical"] = (torch.equal(a[0], b[0]) and
                                     torch.equal(a[1], b[1]) and
                                     torch.equal(a[0], gf))
    ok &= all(stored.values())
    del a, b
    ms = time_ms(torch, lambda: lf.lpgf_force_cuda(xt, rt, gt), 5)
    plain = time_ms(torch, lambda: ref.lpgf_force(xt, rt, gt), 2)
    # torch.cdist computes the distances only, not the function: logged
    # beside the kernel, no library time in the JSON row
    cdist = time_ms(torch, lambda: torch.cdist(
        xt, xt, compute_mode="use_mm_for_euclid_dist"), 5)
    # device time of each of the four kernels of one call
    trace = _trace(torch, lambda: lf.lpgf_force_cuda(xt, rt, gt), 1)
    # the least work of the function: every squared distance once, N^2*D
    # operations with the Gram matrix's symmetry, and w @ x, 2*N^2*D (the
    # kernels do N^2*D + N*128*D on the upper-triangle tiles and 2*N^2*D,
    # plus the unused norm chain of w @ x's tile)
    bms, by = bound_ms(3.0 * n * n * dim, 4.0 * (2 * n * dim + n))
    return ok, dict(
        name="lpgf_force", route="cuda",
        source="src/repro_torch/csrc/lpgf_force.cu",
        replaces="src/repro/kernels/lpgf_force.py:84",
        max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=None, shape=f"({n}, {dim}); also (1000, "
        f"{dim}), (1000, 37), (1000, 2048) and Gaussian ({n}, {dim})",
        library=f"none; torch.cdist, the distances only, {cdist:.4f} ms",
        stored=stored, trace=trace)


# (B, S, H, hd), type, causal, window, inputs: flash_attention's further
# cases. bf16 at hd 64 and 128 takes the wgmma kernel, and those cases are
# held on the SIMT kernel too (launched by name). Inputs (``_flash_inputs``):
# "normal" Gaussian; "strided" views whose strides (hd + 4 elements) and
# bases break TMA's 16-byte rule, so the wgmma route must take its
# explicit contiguous copy; "cancel" rows whose output is near 0, where
# one bf16 P would break the tolerance and only the P_hi + P_lo split
# keeps it.
FLASH_CASES = (((1, 512, 4, 64), "float32", True, 0, "normal"),
               ((1, 512, 4, 64), "float32", True, 128, "normal"),
               ((1, 512, 4, 64), "float32", False, 0, "normal"),
               ((1, 1000, 16, 64), "bfloat16", True, 0, "normal"),
               ((2, 1000, 32, 128), "bfloat16", True, 0, "normal"),
               ((1, 1024, 32, 128), "bfloat16", True, 256, "normal"),
               ((1, 512, 32, 128), "bfloat16", False, 0, "normal"),
               ((1, 512, 8, 128), "bfloat16", True, 0, "strided"),
               ((1, 512, 8, 64), "bfloat16", False, 0, "cancel"),
               ((1, 512, 8, 128), "bfloat16", False, 0, "cancel"))
# the SIMT kernel's times before its Hopper redesign (the first design:
# 64-query blocks, 4 x 4 scores a thread, synchronous staging), at the
# fp32 causal shapes its paths launch it with: two runs each of that
# tree's own check_flash (commit 3f844f8), in turns with this tree's
# (PERF.md section 6)
SIMT_BEFORE_MS = {(2, 2032, 16, 128): (1.4543, 1.4577),
                  (2, 1000, 16, 128): (0.3934, 0.3947),
                  (2, 1000, 4, 16): (0.0588, 0.0598)}
SIMT_BEFORE_SOURCE = ("check_flash of commit 3f844f8, the tree before the "
                      "redesign, NVIDIA H100 80GB HBM3, 700.00 W; not "
                      "measured in this run")
# the JSON row of each route: (name, source)
FLASH_ROWS = {"wgmma": ("flash_attention_wgmma",
                        "src/repro_torch/csrc/flash_attention_wgmma.cu"),
              "simt": ("flash_attention",
                       "src/repro_torch/csrc/flash_attention.cu")}


def _attn_pairs(s: int, causal: bool, window: int) -> int:
    """The (query, key) pairs the mask leaves open: the function's work."""
    import numpy as np
    i = np.arange(s, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros_like(i)
    hi = i if causal else np.full_like(i, s - 1)
    return int(np.maximum(0, hi - lo + 1).sum())


def _keep(torch, s: int, causal: bool, window: int, device, r0: int = 0,
          r1=None):
    """(r1 - r0, S) bool: the (query, key) pairs the mask leaves open, for
    queries r0:r1 (all S by default)."""
    r1 = s if r1 is None else r1
    qpos = torch.arange(r0, r1, device=device)
    kpos = torch.arange(s, device=device)
    keep = torch.ones((r1 - r0, s), dtype=torch.bool, device=device)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window:
        keep &= kpos[None, :] > qpos[:, None] - window
    return keep


def _score_err(torch, q, k, v, want, causal: bool, window: int,
               r0: int = 0):
    """First-order bound on the output error that the fp32 rounding of the
    scores causes, on both sides (kernel and plain version): a score s_j
    summed from hd products errs by at most (hd + 2) u sum_d |q_d k_jd| /
    sqrt(hd), which moves the output by sum_j w_j ds_j (v_j - out), so
    |d out| <= 2 (hd + 2) u sum_j w_j m_j (|v_j| + |out|), m_j the
    magnitude sum. Where the scores reach hundreds (a real prefill's), it
    exceeds the output's own bf16 rounding whenever two keys share the
    weight. ``q`` and ``want`` may be the block of queries from r0 on."""
    b, s, h, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    mask = _keep(torch, k.shape[1], causal, window, q.device, r0, r0 + s)
    out = torch.empty_like(want)
    for i in range(b):     # one batch row at a time: (H, S, S) temporaries
        qf, kf = q[i].float(), k[i].float()
        w = torch.softmax(torch.where(mask, torch.einsum(
            "qhd,khd->hqk", qf, kf) * scale, -1e30), dim=-1)
        w *= torch.einsum("qhd,khd->hqk", qf.abs(), kf.abs()) * scale
        out[i] = torch.einsum("hqk,khd->qhd", w, v[i].float().abs()) \
            + w.sum(-1).T[:, :, None] * want[i].abs()
        del w
    return 2.0 * (hd + 2) * U32 * out


def flash_check(torch, ref, q, k, v, got, causal: bool, window: int,
                score_err: bool = False, rows=None):
    """``got`` (the kernel's output) against the plain version. fp32:
    |a - b| <= 2e-5 + 2e-5 |b|. bf16: |a - b| <= 2^-8 |b| + 2^-16 max|v|,
    b the plain version's fp32 result on the widened inputs (one rounding
    to bf16 plus summation noise near zero); with ``score_err`` the
    scores' own fp32 rounding (``_score_err``) is added. ``rows``: the
    plain version runs on that many queries at a time (``q_offset``),
    for a prompt too long for its (S, S) scores. Returns (ok, max
    |a - b|, entries over the bf16 tolerance without the scores' term)."""
    rows = rows or q.shape[1]
    wide = q.dtype != torch.float32
    kf, vf = (k.float(), v.float()) if wide else (k, v)
    vmax = float(vf.abs().max())
    ok, err, over = True, 0.0, 0
    for r0 in range(0, q.shape[1], rows):
        qb, gb = q[:, r0:r0 + rows], got[:, r0:r0 + rows]
        want = ref.flash_attention(qb.float() if wide else qb, kf, vf,
                                   causal=causal, window=window,
                                   q_offset=r0)
        e = (gb.float() - want).abs()
        if wide:
            tol = 2.0 ** -8 * want.abs() + 2.0 ** -16 * vmax
        else:
            tol = 2e-5 + 2e-5 * want.abs()
        n = int((e > tol).sum())
        if wide and score_err and n:
            tol += _score_err(torch, qb, k, v, want, causal, window, r0)
        ok = ok and bool((e <= tol).all())
        err, over = max(err, float(e.max())), over + n
        del want, e, tol
    return ok, err, over


def _flash_inputs(torch, shape, dt, dev, gen, inputs: str):
    """q, k, v of ``shape`` and type ``dt`` on the card (see
    ``FLASH_CASES``). "cancel" is tests/test_torch_flash.py's split case,
    each row's c cycling through that test's 64 values: keys 0 and 1
    share the weight (neither normalised weight representable in bf16),
    every other key has weight 0, and their values in column 0 (1 and
    -1.5) nearly cancel. Non-causal only."""
    b, s, h, hd = shape
    if inputs == "cancel":
        c = 1.0 + 2.0 ** -7 * (torch.arange(s, device=dev) % 64 - 32)
        q = torch.zeros(shape, device=dev)
        q[..., 0] = c[None, :, None]
        k = torch.zeros(shape, device=dev)
        k[:, 0, :, 0] = 3.25 * math.sqrt(hd) / 8
        k[:, 2:, :, 0] = -1e4
        v = torch.rand(shape, generator=gen, device=dev) * 3 - 1.5
        v[:, 0, :, 0], v[:, 1, :, 0] = 1.0, -1.5
        return tuple(t.to(dt) for t in (q, k, v))
    pad = 4 if inputs == "strided" else 0
    return tuple(torch.randn((b, s, h, hd + pad), generator=gen,
                             device=dev).to(dt)[..., pad:]
                 for _ in range(3))


def host_ms(torch, fn, reps: int) -> float:
    """Mean host time of one call of ``fn`` (the wrapper's checks and
    copies, the tensor maps, the launch), the card idle before each."""
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


def sdpa_call(torch, q, k, v, causal: bool, window: int):
    """``scaled_dot_product_attention`` computing the flash function on
    (B, S, H, hd) q, k, v: ``is_causal`` without a window; with one, a
    boolean (S, S) mask of the open pairs (``_keep``)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not window:
        return lambda: sdpa(qt, kt, vt, is_causal=causal)
    mask = _keep(torch, q.shape[1], causal, window, q.device)
    return lambda: sdpa(qt, kt, vt, attn_mask=mask)


def sdpa_dispatch(torch, q, k, v, causal: bool, window: int = 0) -> str:
    """The backend ``scaled_dot_product_attention`` took on (B, S, H, hd)
    q, k, v (``sdpa_call``): the ``aten::_scaled_dot_product_*`` operator
    it dispatched to, read from ``torch.profiler`` over one call."""
    from torch.profiler import ProfilerActivity, profile
    call = sdpa_call(torch, q, k, v, causal, window)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
        torch.cuda.synchronize()
    return ", ".join(sorted({e.key for e in prof.key_averages()
                             if e.key.startswith("aten::_scaled_dot_product")}
                            ))

def check_flash(torch, fa, ref, dev, gen, shape, dtype: str, causal: bool,
                window: int, inputs: str = "normal", kernel=None,
                sdpa_backend: bool = False):
    """``flash_attention`` at ``shape`` against its plain version
    (``flash_check``), through ``fa.flash_attention_cuda`` (the route
    ``fa.route`` gives the inputs) or, when ``kernel`` is named, on that
    kernel (``fa._launch``, to compare the two at one shape); timed on
    the card and on the host, beside the plain version and
    ``scaled_dot_product_attention`` (``sdpa_call``: with a window, on a
    boolean mask; with ``sdpa_backend``, the backend it took and whether
    TF32 was allowed)."""
    dt = getattr(torch, dtype)
    b, s, h, hd = shape
    q, k, v = _flash_inputs(torch, shape, dt, dev, gen, inputs)
    route = kernel or fa.route(dt, hd)
    if kernel is None:
        def call():
            return fa.flash_attention_cuda(q, k, v, causal=causal,
                                           window=window)
    else:
        def call():
            return fa._launch(q, k, v, causal, window, kernel)
    before = fa.launches_by_route[route]
    got = call()
    routed = fa.launches_by_route[route] == before + 1
    ok, err, _ = flash_check(torch, ref, q, k, v, got, causal, window)
    del got
    ms = time_ms(torch, call, 10)
    host = host_ms(torch, call, 10)
    plain = time_ms(torch, lambda: ref.flash_attention(
        q, k, v, causal=causal, window=window), 3)
    lib = time_ms(torch, sdpa_call(torch, q, k, v, causal, window), 10)
    # the pairs the mask leaves open, two products of hd each (scores and
    # weights times V), at the peak for the inputs' type; q, k, v read and
    # the output written once. The wgmma kernel does 1.5x these
    # operations (P.V twice, for P's two bf16 halves); the bound counts
    # the function's.
    ops = 4.0 * hd * b * h * _attn_pairs(s, causal, window)
    bms, by = bound_ms(ops, 4.0 * b * s * h * hd * q.element_size(),
                       "bf16" if dt == torch.bfloat16 else "fp32")
    mask = ("causal" if causal else "non-causal") + (
        f", window {window}" if window else "") + {
        "normal": "", "strided": ", strided (hd + 4), copied",
        "cancel": ", values that cancel"}[inputs]
    name, source = FLASH_ROWS[route]
    return ok and routed, dict(
        name=name, route="cuda", source=source,
        replaces="src/repro/kernels/flash_attention.py:70",
        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib, shape=f"{shape} {dtype} {mask}, {route} kernel",
        tflops=ops / ms / 1e9, host_ms=host,
        library=("scaled_dot_product_attention"
                 + (" on a boolean mask" if window else "") + (
            f"; backend {sdpa_dispatch(torch, q, k, v, causal, window)}, "
            f"allow_tf32 (matmul) "
            f"{torch.backends.cuda.matmul.allow_tf32}, (cudnn) "
            f"{torch.backends.cudnn.allow_tf32}" if sdpa_backend else "")))


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


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def build_platform(args, dev, rows: int, **prepare_kw):
    """``MQRLD(table).prepare(**prepare_kw)`` on a table of 12-centre
    Gaussian blobs (``rows`` x ``args.dim``, as benchmarks/bench_engine.py
    draws them at d=32) plus a uniform ``price`` column, and a V.R radius
    from the data: the median 100th-nearest-neighbour distance of 64
    sampled rows (a fixed radius selects nothing at 512-d). Returns
    (platform, radius, prepare s)."""
    import numpy as np
    import torch
    from repro_torch.core.lake import MMOTable
    from repro_torch.core.platform import MQRLD

    rng = np.random.default_rng(args.seed)
    centers = rng.normal(size=(12, args.dim)).astype(np.float32) * 6
    cat = rng.integers(0, 12, rows)
    vec = (centers[cat] + rng.normal(size=(rows, args.dim))
           ).astype(np.float32)
    price = rng.uniform(0, 100, rows).astype(np.float32)
    table = MMOTable("smoke").add_vector("v", vec).add_numeric("price",
                                                               price)
    p = MQRLD(table, seed=args.seed,
              device=None if dev.type == "cuda" else dev)
    t0 = time.time()
    p.prepare(**prepare_kw)
    _sync(torch, dev)
    t_prep = time.time() - t0
    xs = torch.as_tensor(p.table.vector["v"], device=dev)
    samp = xs[torch.as_tensor(rng.choice(rows, 64, replace=False),
                              device=dev)]
    d100 = torch.cdist(samp, xs).kthvalue(101, dim=1).values
    radius = float(f"{float(d100.median()):.4g}")
    return p, radius, t_prep


def run_batch(args, dev, sess, batch):
    """One warm and one timed execution of ``batch`` on ``sess``: (rows,
    stats, warm s, timed s)."""
    import torch
    t0 = time.time()
    sess.plan(batch).execute()
    _sync(torch, dev)
    t_warm = time.time() - t0
    t0 = time.time()
    res, stats = sess.plan(batch).execute()
    _sync(torch, dev)
    return res, stats, t_warm, time.time() - t0


def drive_main_path(args, dev):
    """The port's fp32 main path through the entry points a user calls:
    ``build_platform`` at ``args.rows`` rows, then ``session().plan(batch)
    .execute()`` on the hybrid batch, once to warm and once timed.
    Returns (platform, batch, rows, stats, (prepare s, radius, warm s,
    timed s))."""
    import numpy as np
    from repro_torch.core import query as Q

    p, radius, t_prep = build_platform(args, dev, args.rows, min_leaf=64,
                                       max_leaf=1024)
    batch = hybrid_batch(Q, np, p.table.vector["v"], radius, args.batch,
                         args.seed + 1)
    res, stats, t_warm, t_exec = run_batch(args, dev, p.session(), batch)
    return p, batch, res, stats, (t_prep, radius, t_warm, t_exec)


def large_k_batch(Q, np, vecs, seed: int):
    """16 top-level V.K queries, half at k = 300 and half at k = 1000."""
    rng = np.random.default_rng(seed)
    return [Q.VK.of("v", vecs[i], 300 if j % 2 == 0 else 1000)
            for j, i in enumerate(rng.integers(0, len(vecs), 16))]


def oracle_mismatches(p, batch, res):
    """(indices of queries whose rows differ from ``p.oracle``, truths)."""
    import numpy as np
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        truths = list(ex.map(p.oracle, batch))
    return [i for i, (r, t) in enumerate(zip(res, truths))
            if not np.array_equal(r, t)], truths


def _counters(kmods):
    """The launch counts of every kernel wrapper, by kernel name (the two
    flash kernels by route: ``flash_attention`` is the SIMT one)."""
    pw, ft, qk, lf, fa = kmods
    return {"pairwise_sq_l2": pw.launches, "topk_l2": ft.topk_l2_launches,
            "topk_l2_masked": ft.topk_l2_masked_launches,
            "quant_lb2": qk.launches, "lpgf_force": lf.launches,
            "flash_attention_wgmma": fa.launches_by_route["wgmma"],
            "flash_attention": fa.launches_by_route["simt"]}


def _reset(kmods):
    pw, ft, qk, lf, fa = kmods
    pw.launches = qk.launches = lf.launches = 0
    ft.reset_launches()
    fa.reset_launches()


# ------------------------------------------------------- planner paths
SCALAR_FORMS = ("VK", "NR", "VR", "NR_and_VK", "VK_in_or_in_and",
                "VK_or_VR")


def scalar_form(Q, v, w, lo: float, radius: float, form: str):
    """One query of a scalar-path form around the vectors ``v``, ``w``:
    V.K at k = 20, N.R over [lo, lo + 5], V.R, a filtered V.K, a V.K
    under an Or under an And (which the batched engine cannot plan) and
    an Or of a V.K and a V.R."""
    return {
        "VK": lambda: Q.VK.of("v", v, 20),
        "NR": lambda: Q.NR("price", lo, lo + 5),
        "VR": lambda: Q.VR.of("v", v, radius),
        "NR_and_VK": lambda: Q.And.of(Q.NR("price", 25, 75),
                                      Q.VK.of("v", v, 20)),
        "VK_in_or_in_and": lambda: Q.And.of(
            Q.Or.of(Q.VK.of("v", v, 20), Q.NR("price", 0, 1)),
            Q.NR("price", 0, 60)),
        "VK_or_VR": lambda: Q.Or.of(Q.VK.of("v", v, 20),
                                    Q.VR.of("v", w, radius)),
    }[form]()


def drive_scalar_path(args, dev, p, radius: float, kmods):
    """The scalar path: 8 queries of each ``SCALAR_FORMS`` form through
    ``MQRLD.execute(record=False)``, each row-equal to the oracle (ms per
    query by form); then a 64-query planned batch, 16 of them not
    plannable for the engine, through ``session().plan().execute()``:
    ``explain()["n_scalar"]`` must be 16 and every row the oracle's.
    Returns (error or None, info)."""
    import numpy as np
    import torch
    from repro_torch.core import query as Q

    vecs = p.table.vector["v"]
    rng = np.random.default_rng(args.seed + 4)
    info = {"ms_per_query": {}}
    for form in SCALAR_FORMS:
        qs = [scalar_form(Q, vecs[i], vecs[j], float(lo), radius, form)
              for (i, j), lo in zip(rng.integers(0, len(vecs), (8, 2)),
                                    rng.uniform(0, 95, 8))]
        t0 = time.time()
        res = [p.execute(q, record=False)[0] for q in qs]
        info["ms_per_query"][form] = (time.time() - t0) * 1e3 / len(qs)
        bad, _ = oracle_mismatches(p, qs, res)
        if bad:
            return f"scalar {form}: query {bad[0]} differs from the " \
                   f"oracle", info
    batch = hybrid_batch(Q, np, vecs, radius, 48, args.seed + 5)
    batch += [scalar_form(Q, vecs[i], None, 0.0, radius, "VK_in_or_in_and")
              for i in rng.integers(0, len(vecs), 16)]
    plan = p.session().plan(batch)
    info["n_scalar"] = plan.explain()["n_scalar"]
    _reset(kmods)
    t0 = time.time()
    res, _ = plan.execute()
    _sync(torch, dev)
    info["planned_batch_s"] = time.time() - t0
    info["launches"] = _counters(kmods)
    bad, _ = oracle_mismatches(p, batch, res)
    info["planned_batch_mismatches"] = len(bad)
    if info["n_scalar"] != 16:
        return f"planned batch: n_scalar {info['n_scalar']}, want 16", info
    if bad:
        return f"planned batch: query {bad[0]} differs from the oracle", info
    return None, info


def drive_executors(args, dev, p, kmods):
    """``BatchedExecutor`` on the card and ``HostExecutor`` over the
    platform's tree and enhanced features: 64 V.K queries at k = 20
    (rows of the table, jittered), each executor's rows equal to the
    brute-force oracle's over those features. Returns (error or None,
    info, the host executor)."""
    import numpy as np
    import torch
    from repro_torch.core import query as Q
    from repro_torch.core.index import BatchedExecutor, HostExecutor
    from repro_torch.core.lake import MMOTable

    data = p.enhanced
    rng = np.random.default_rng(args.seed + 6)
    qs = (data[rng.integers(0, len(data), 64)] + rng.normal(
        0, 0.01, (64, data.shape[1]))).astype(np.float32)
    info = {}
    t0 = time.time()
    bat = BatchedExecutor(p.tree, data, device=dev)
    _sync(torch, dev)
    info["batched_build_s"] = time.time() - t0
    bat.knn(qs[:8], 20)                         # warm
    _reset(kmods)
    t0 = time.time()
    _, brows, bst = bat.knn(qs, 20)
    _sync(torch, dev)
    info["batched_s"] = time.time() - t0
    info["batched_launches"] = _counters(kmods)
    info["batched_widened"] = bat.exact_fallbacks
    info["batched_rows_scanned"] = bst.rows_scanned
    host = HostExecutor(p.tree, data)
    t0 = time.time()
    hres = [host.knn(q, 20) for q in qs]
    info["host_s"] = time.time() - t0
    info["host_nodes_scanned"] = sum(s.nodes_scanned for _, s in hres)
    feats = MMOTable("enhanced").add_vector("e", data)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        truths = list(ex.map(lambda q: Q.execute_bruteforce(
            feats, Q.VK.of("e", q, 20)), qs))
    bad_b = [i for i, t in enumerate(truths)
             if not np.array_equal(brows[i], t)]
    bad_h = [i for i, t in enumerate(truths)
             if not np.array_equal(hres[i][0], t)]
    info["mismatches"] = {"batched": len(bad_b), "host": len(bad_h)}
    if bad_b or bad_h:
        return f"executors differ from the brute force: {info}", info, host
    if info["batched_launches"]["topk_l2_masked"] <= 0:
        return "BatchedExecutor launched no topk_l2_masked", info, host
    return None, info, host


def drive_reorder(args, p, host):
    """Algorithm 3 on a skewed workload: 32 V.K queries at k = 20 at the
    rows of one leaf through ``p.optimize_index``. The scalar path walks
    leaves in lower-bound order, so its work cannot depend on the sibling
    order: its rows and its totals of ``QueryStats.nodes_scanned``
    (which it does not count: 0), ``buckets_touched`` and
    ``rows_scanned`` must be the same after as before. The sibling order
    steers the host executor's traversal only: its rows on the same
    rows' enhanced features must not change, and its total nodes scanned
    before and after is reported. Returns (error or None, info)."""
    import numpy as np
    from repro_torch.core import query as Q

    tree = p.tree
    rng = np.random.default_rng(args.seed + 7)
    leaf = tree.leaf_ids[rng.integers(0, len(tree.leaf_ids))]
    rows = np.arange(int(tree.bucket_start[leaf]),
                     int(tree.bucket_end[leaf]))[:32]
    workload = [Q.VK.of("v", p.table.vector["v"][i], 20) for i in rows]
    feats = p.enhanced[rows]

    def run():
        host_out = [host.knn(q, 20) for q in feats]
        out = [p.execute(q, record=False) for q in workload]
        work = {f"scalar_{k}": sum(getattr(s, k) for _, s in out)
                for k in ("nodes_scanned", "buckets_touched",
                          "rows_scanned")}
        work["host_nodes_scanned"] = sum(s.nodes_scanned
                                         for _, s in host_out)
        return [r for r, _ in host_out + out], work
    rows0, before = run()
    t0 = time.time()
    changed = p.optimize_index(workload)
    info = {"queries": len(workload), "changed": changed,
            "optimize_s": time.time() - t0}
    rows1, after = run()
    info.update(before=before, after=after)
    if any(not np.array_equal(a, b) for a, b in zip(rows0, rows1)):
        return "reordering changed a query's rows", info
    bad, _ = oracle_mismatches(p, workload, rows1[len(workload):])
    if bad:
        return f"reorder: query {bad[0]} differs from the oracle", info
    if any(after[k] != before[k] for k in before if k.startswith("scalar")):
        return f"reordering changed the scalar path's work: {info}", info
    return None, info


def drive_calibration(args, dev, p, batch, truths, t_uncal: float, kmods):
    """``p.calibrate(batch=16)`` after warming both beam loops, then the
    timed hybrid batch again in a fresh session under the fitted model:
    its seconds beside the uncalibrated ``t_uncal``, how its loop was
    chosen, the V.R routes the engine took, every row the oracle's.
    Returns (error or None, info)."""
    import numpy as np
    import torch
    from repro_torch.core.planner import Session

    p.session(device_loop=False).plan(batch).execute()   # warm
    _sync(torch, dev)
    _reset(kmods)
    t0 = time.time()
    model = p.calibrate(batch=16)
    _sync(torch, dev)
    info = {"calibrate_s": time.time() - t0, "sweep_s": model.sweep_s,
            "launches": _counters(kmods), "host": model.host,
            "kinds": {k: {"samples": len(p.qbs.cost_samples(k)[1]),
                          "fitted_on": v["n"], "err": v["err"],
                          "reliable": model.reliable(k)}
                      for k, v in model.kinds.items()}}
    sess = Session(p)
    res, st, t_warm, t_exec = run_batch(args, dev, sess, batch)
    plan = sess.plan(batch)
    info.update(batch_s=t_exec, qps=len(batch) / t_exec,
                uncalibrated_qps=len(batch) / t_uncal,
                choices=plan.explain()["cost_model"]["choices"],
                device_loop=plan.logical.device_loop,
                vr_routes=[k for k, _, _ in st.stage_samples
                           if k.startswith("vr:")])
    bad = [i for i, (r, t) in enumerate(zip(res, truths))
           if not np.array_equal(r, t)]
    info["mismatches"] = len(bad)
    if bad:
        return f"calibrated batch: query {bad[0]} differs from the " \
               f"oracle", info
    if min(info["launches"][n] for n in ("pairwise_sq_l2",
                                         "topk_l2_masked")) <= 0:
        return f"calibration launched no engine kernel: {info}", info
    return None, info


# ------------------------------------------------------------ ingest path
# 3 appends of 5,000 rows: cut from 8 of 2,500, then from 4 of 5,000, for
# the time limit (PERF.md §4)
INGEST_APPENDS, INGEST_ROWS = 3, 5000
FULL_CHECK_AFTER = (0, INGEST_APPENDS - 1)   # appends checked on all queries
SLICE = 64        # queries checked after the other appends


def blob_centers(args):
    """The 12 centres ``build_platform`` draws its blobs around (the first
    draw of its generator)."""
    import numpy as np
    rng = np.random.default_rng(args.seed)
    return rng.normal(size=(12, args.dim)).astype(np.float32) * 6


def drive_ingest_path(args, dev, p, batch, kmods):
    """Ingest on the prepared platform of the fp32 path: the hybrid batch
    on the fp32 device loop as the baseline, then ``INGEST_APPENDS``
    appends of ``INGEST_ROWS`` rows each (blobs around the same centres,
    ``fold=False``; the first holds a row 1e-3 from the vector of the
    batch's first query, which must answer it), each followed by the
    engine's ``sync_delta`` and the batch on the fp32 device loop, every
    row the oracle's over ``view()`` (all queries after the first and the
    last append, the first ``SLICE`` after the others). After the last
    append the batch also runs on the host loop and in int8 and bf16;
    then ``fold()``, the engines rebuilt, and the batch again on both
    loops and in all three precisions. Each run is timed four times (the
    first, and the median of the rest). Every KNN width recorded while
    the delta is live must carry the ``:delta`` suffix. Returns (error or
    None, info)."""
    import numpy as np
    import torch

    info = {"appends": [], "checks": []}
    rng = np.random.default_rng(args.seed + 8)
    centers = blob_centers(args)
    nb = p.n_base
    sess = p.session()

    def run(label, session, device_loop=True, queries=None):
        """The batch on ``session`` four times: the first run's seconds,
        and the median of the other three (the host clock spreads between
        calls); the first run's rows checked against the oracle (on
        ``queries`` of them). Returns (error or None, rows, stats)."""
        times = []
        for i in range(4):
            t0 = time.time()
            out, st = session.plan(batch, device_loop=device_loop).execute()
            _sync(torch, dev)
            times.append(time.time() - t0)
            if i == 0:
                res = out
        secs = sorted(times[1:])[1]
        n = len(batch) if queries is None else queries
        t0 = time.time()
        bad, _ = oracle_mismatches(p, batch[:n], res[:n])
        info["checks"].append({
            "run": label, "first_s": times[0], "batch_s": secs,
            "qps": len(batch) / secs, "checked": n, "mismatches": len(bad),
            "oracle_s": time.time() - t0})
        if bad:
            return f"ingest {label}: query {bad[0]} differs from the " \
                   f"oracle", res, st
        return None, res, st

    _reset(kmods)
    t_path = time.time()
    err, _, _ = run("base, before any append", sess)
    if err:
        return err, info
    for j in range(INGEST_APPENDS):
        lab = rng.integers(0, 12, INGEST_ROWS)
        vec = (centers[lab] + rng.normal(size=(INGEST_ROWS, args.dim))
               ).astype(np.float32)
        if j == 0:
            vec[0] = batch[0].vec() + np.float32(1e-3)
        price = rng.uniform(0, 100, INGEST_ROWS).astype(np.float32)
        t0 = time.time()
        p.append(numeric={"price": price}, vector={"v": vec}, fold=False)
        t_app = time.time() - t0
        t0 = time.time()
        eng = sess.engine()              # sync_delta: the union, uploaded
        _sync(torch, dev)
        t_sync = time.time() - t0
        full = j in FULL_CHECK_AFTER
        err, res, st = run(f"append {j + 1}", sess,
                           queries=None if full else SLICE)
        info["appends"].append({
            "rows": p.n_delta, "capacity": p.delta.capacity,
            "append_ms": t_app * 1e3, "sync_ms": t_sync * 1e3,
            "delta_tiles": eng.delta_tiles,
            "delta_tiles_device_layout": eng.geom_dev["v"].n_leaves
            - eng._base["geom_dev"]["v"].n_leaves,
            "widths": sorted({a for a, _ in st.knn_group_widths})})
        if err:
            return err, info
        if j == 0 and nb not in res[0].tolist():
            return (f"ingest: the row appended 1e-3 from query 0's vector "
                    f"(id {nb}) is not in its answer {res[0][:5]}"), info
        if not st.knn_group_widths or not all(
                a.endswith(":delta") for a, _ in st.knn_group_widths):
            return (f"ingest: widths recorded during the delta without "
                    f"the :delta suffix: {st.knn_group_widths}"), info
        if max(int(r.max(initial=-1)) for r in res) >= nb + p.n_delta:
            return "ingest: a row id at or past n_base + m", info
    info["delta_stats"] = {k: v for k, v in vars(st).items()
                           if k not in ("stage_samples", "knn_group_widths")}
    # the grouping's share of a sync at the full delta (deterministic:
    # the same groups the last sync cut)
    t0 = time.time()
    eng._delta_groups(p.delta)
    _sync(torch, dev)
    info["delta_groups_s"] = time.time() - t0
    info["n_pad_rows"] = p.delta.capacity - p.n_delta
    err, _, _ = run("delta, host loop", sess, device_loop=False)
    if err:
        return err, info
    for prec in ("int8", "bf16"):
        t0 = time.time()
        ps = p.session(precision=prec)
        ps.engine()
        _sync(torch, dev)
        info[f"{prec}_sync_s"] = time.time() - t0
        err, _, st = run(f"delta, {prec}", ps)
        if err:
            return err, info
    t0 = time.time()
    info["folded"] = p.fold()
    info["fold_s"] = time.time() - t0
    info["rows_after_fold"] = p.n_base
    for prec in ("fp32", "int8", "bf16"):
        t0 = time.time()
        p.session(precision=prec).engine()
        _sync(torch, dev)
        info[f"rebuild_{prec}_s"] = time.time() - t0
    for label, session, dl in (
            ("folded", sess, True), ("folded, host loop", sess, False),
            ("folded, int8", p.session(precision="int8"), True),
            ("folded, bf16", p.session(precision="bf16"), True)):
        err, res, st = run(label, session, device_loop=dl)
        if err:
            return err, info
        if any(a.endswith(":delta") for a, _ in st.knn_group_widths):
            return f"ingest {label}: a :delta width after the fold", info
    info["path_s"] = time.time() - t_path
    info["launches"] = _counters(kmods)
    info["oracle_s"] = sum(c["oracle_s"] for c in info["checks"])
    return None, info


# ------------------------------------------------------- persistence path
PERSIST_ROWS = 2500      # rows appended before the save: a live delta
PERSIST_CHECK = 64       # queries of the loaded platform held to the oracle


def _dir_bytes(root: str) -> dict:
    """Bytes on disk under ``root``, by file (relative paths) and total."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            out[os.path.relpath(path, root)] = os.path.getsize(path)
    out["total"] = sum(out.values())
    return out


def check_sync_free_dispatch(torch, p, batch, precision: str):
    """The enqueue half of the engine's ``_dispatch_jobs`` on the device
    loop for ``batch`` (its predicate masks taken first: host numpy, a
    sync of their own) under ``torch.cuda.set_sync_debug_mode("error")``,
    which raises at any host sync; then its finish, whose rows must be
    ``execute_batch``'s. Returns (error or None, seconds of the
    enqueue)."""
    import numpy as np
    from repro_torch.core.engine import EngineStats
    eng = p.engine(precision=precision)
    want, _ = eng.execute_batch(batch, device_loop=True)
    stats = EngineStats(queries=len(batch))
    pred = eng._stage_batch(batch, stats, True, None)
    jobs, groups, _ = eng._plan_jobs(batch, pred, None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    t0 = time.time()
    try:
        pend = eng._dispatch_jobs(jobs, stats, True, eager=False)
    except RuntimeError as e:
        return f"{precision}: the enqueue half synced: {e}", 0.0
    finally:
        t_enq = time.time() - t0
        torch.cuda.set_sync_debug_mode(0)
    got = eng._finish_walk(batch, pred, jobs, pend.finish())
    if any(not np.array_equal(a, b) for a, b in zip(got, want)):
        return f"{precision}: the dispatched batch's rows differ", t_enq
    return None, t_enq


def drive_persist_path(args, dev, p, batch, kmods, keep=None):
    """Path (h), on (g)'s folded platform with ``default_precision =
    "int8"``: ``PERSIST_ROWS`` rows appended (a live delta), the fp32 and
    int8 batches on the live platform, ``save_platform`` into a temporary
    directory, ``load_platform`` on the card, and the batch in fp32 and
    int8 on the loaded platform: every row the live platform's, the first
    ``PERSIST_CHECK`` queries the oracle's. The loaded int8 engine must
    take the persisted planes as they are (no ``plan_tiles`` call for a
    base layout; its planes the loaded arrays themselves, equal to the
    live engine's bit for bit). Then the enqueue half of the engine's
    dispatch under the sync guard, in fp32 and int8
    (``check_sync_free_dispatch``). ``keep`` (a dict) receives the live
    platform's rows by precision (``live``) and the oracle's rows of the
    first ``PERSIST_CHECK`` queries (``truths``), which path (o) reuses.
    Returns (error or None, info, the loaded platform)."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.core import persist
    from repro_torch.utils import quant

    info = {}
    rng = np.random.default_rng(args.seed + 9)
    centers = blob_centers(args)
    p.default_precision = "int8"
    p.engine(precision="int8")   # (g) rebuilt it: the planes to persist
    lab = rng.integers(0, 12, PERSIST_ROWS)
    vec = (centers[lab] + rng.normal(size=(PERSIST_ROWS, args.dim))
           ).astype(np.float32)
    price = rng.uniform(0, 100, PERSIST_ROWS).astype(np.float32)
    p.append(numeric={"price": price}, vector={"v": vec}, fold=False)
    _reset(kmods)
    live = {}
    for prec in ("fp32", "int8"):
        live[prec], _, _, info[f"live_{prec}_batch_s"] = run_batch(
            args, dev, p.session(precision=prec), batch)
    live_planes = p.engine(precision="int8").snapshot_planes()
    calls = []
    real = quant.plan_tiles

    def counted(tiles, valid, precision):
        calls.append(tuple(np.asarray(tiles).shape))
        return real(tiles, valid, precision)

    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        persist.save_platform(p, d)
        info["save_s"] = time.time() - t0
        info["bytes"] = _dir_bytes(d)
        info["current"] = persist.current_generation(d)
        t0 = time.time()
        p2 = persist.load_platform(
            d, device=None if dev.type == "cuda" else dev)
        info["load_s"] = time.time() - t0
    quant.plan_tiles = counted
    try:
        t0 = time.time()
        eng = p2.engine(precision="int8")
        _sync(torch, dev)
        info["int8_engine_s"] = time.time() - t0
    finally:
        quant.plan_tiles = real
    base = {tuple(eng._base[k]["v"].shape) for k in ("vec_tiles",
                                                     "vec_tiles_dev")}
    info["plan_tiles_calls"] = calls
    cache = p2._quant_cache
    taken = all(np.shares_memory(eng._planes_np[(lay, "v")].data,
                                 cache[f"{lay}__v__data"])
                for lay in ("host", "dev"))
    snap = eng.snapshot_planes()
    bits = snap.keys() == live_planes.keys() and all(
        np.array_equal(v, live_planes[k]) for k, v in snap.items())
    info.update(planes_taken=taken, planes_equal_live=bits,
                n_delta_loaded=p2.n_delta,
                generation=(p.generation, p2.generation))
    if any(c in base for c in calls) or not taken or not bits:
        return (f"persistence: the loaded int8 engine did not take the "
                f"persisted planes (plan_tiles on {calls}, taken {taken}, "
                f"equal to the live engine's {bits})"), info, p2
    if p2.n_delta != PERSIST_ROWS:
        return f"persistence: {p2.n_delta} delta rows after the load", \
            info, p2
    t0 = time.time()
    p2.engine(precision="fp32")
    _sync(torch, dev)
    info["fp32_engine_s"] = time.time() - t0
    for prec in ("fp32", "int8"):
        got, st, tw, te = run_batch(args, dev, p2.session(precision=prec),
                                    batch)
        info[f"loaded_{prec}_batch_s"] = te
        bad = [i for i, (a, b) in enumerate(zip(got, live[prec]))
               if not np.array_equal(a, b)]
        if bad:
            return (f"persistence {prec}: query {bad[0]} of the loaded "
                    f"platform differs from the live platform's"), info, p2
        t0 = time.time()
        bad, truths = oracle_mismatches(p2, batch[:PERSIST_CHECK],
                                        got[:PERSIST_CHECK])
        info["oracle_s"] = info.get("oracle_s", 0.0) + time.time() - t0
        if keep is not None:
            keep.update(live=live, truths=truths)
        if bad:
            return f"persistence {prec}: query {bad[0]} differs from the " \
                   f"oracle", info, p2
    info["launches"] = _counters(kmods)
    for prec in ("fp32", "int8"):
        err, info[f"sync_free_enqueue_{prec}_s"] = check_sync_free_dispatch(
            torch, p2, batch, prec)
        if err:
            return f"persistence: {err}", info, p2
    return None, info, p2


# (shards, precision, queries of the hybrid batch: None for all of it);
# the S = 1 and int8 runs serve the first 64 queries, to keep the card
# tests plus this script inside the call's time limit
SHARD_RUNS = ((1, "fp32", 64), (2, "fp32", None), (8, "fp32", None),
              (8, "int8", 64))
SHARD_VR = 16            # queries of the V.R batch that takes the tile route


def vr_batch(Q, np, vecs, radius: float, seed: int):
    """``SHARD_VR`` queries around one row, half ``V.R`` and half ``V.R +
    V.K`` (k = 20): one blob's tiles survive their triangle bounds, few
    enough that the uncalibrated engine takes the V.R tile route (a
    batch over every blob unions past ``_VR_DENSE_CUTOFF``)."""
    rng = np.random.default_rng(seed)
    v0 = vecs[int(rng.integers(0, len(vecs)))]
    out = []
    for j in range(SHARD_VR):
        v = (v0 + rng.normal(size=v0.shape) * 0.1).astype(np.float32)
        out.append(Q.VR.of("v", v, radius) if j % 2 == 0 else
                   Q.And.of(Q.VR.of("v", v, radius), Q.VK.of("v", v, 20)))
    return out


def tie_at_kth(Q, np, col, q, got, want) -> bool:
    """Whether ``got`` and ``want`` differ only by rows tied exactly at the
    k-th distance of the query's one V.K: the same count, and every row
    in one but not the other at the largest exact distance (the oracle's
    own formula) of both results."""
    vks = [b for b in Q.basic_queries(q) if isinstance(b, Q.VK)]
    got, want = np.asarray(got), np.asarray(want)
    if len(vks) != 1 or len(got) != len(want):
        return False
    v = vks[0].vec()
    diff = np.setxor1d(got, want)
    if not len(diff):
        return False
    d = lambda rows: ((col[rows] - v[None, :]) ** 2).sum(1)
    kth = d(got).max()
    return bool(kth == d(want).max() and (d(diff) == kth).all())


def drive_sharded_path(args, dev, p, batch, radius: float, single, truths,
                       kmods):
    """Path (o), on (h)'s live platform (200,000 + 2,500 rows, a live
    delta of 2,500, int8 default): ``session(shards=S, precision=...)``
    for each of ``SHARD_RUNS`` through the entry points a user calls,
    uncalibrated (``p.cost_model`` set aside, restored after), so the
    V.R route is the fixed cutoff's. Each run serves the hybrid batch (or
    its first queries, as ``SHARD_RUNS`` says) warm, then timed: every
    row equal to ``single[precision]`` (the same platform's single-device
    rows from path (h)) in ids and order, or differing only by an exact
    tie at the k-th distance (``tie_at_kth``); the first ``len(truths)``
    queries equal to ``truths`` (path (h)'s oracle); ``stats.shards ==
    S``. In fp32 it also serves ``vr_batch``, which must take the sharded
    V.R tile route, its rows equal to the single-device loop's and the
    oracle's (both computed before any run). The launch counters are set
    to 0 just before each run and read just after it, so a run's counts
    are its own: every run must launch ``pairwise_sq_l2``, the fp32 runs
    ``topk_l2_masked`` and the int8 run ``quant_lb2``. Each run's engine is
    derived from the cached single-device one
    (``HybridEngine.with_shards``) and dropped after it. Returns (error or
    None, info)."""
    import numpy as np
    import torch
    from repro_torch.core import query as Q

    col = p.view().vector["v"]
    info = {"runs": []}
    saved_model = p.cost_model
    p.cost_model = None
    if dev.type == "cuda":
        info["resident_gib_before"] = _resident_gib(torch, dev)
    try:
        vb = vr_batch(Q, np, p.table.vector["v"], radius, args.seed + 13)
        single_vr, _ = p.session(shards=0, precision="fp32").plan(
            vb).execute()
        t0 = time.time()
        vr_truth = [p.oracle(q) for q in vb]
        info["vr_oracle_s"] = time.time() - t0
        bad = [i for i, (a, t) in enumerate(zip(single_vr, vr_truth))
               if not np.array_equal(a, t)]
        if bad:
            return f"sharded: V.R query {bad[0]} of the single-device " \
                   f"loop differs from the oracle", info
        for s, prec, nq in SHARD_RUNS:
            qb = batch[:nq] if nq else batch
            run = {"shards": s, "precision": prec, "queries": len(qb)}
            info["runs"].append(run)
            _sync(torch, dev)
            _reset(kmods)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            sess = p.session(shards=s, precision=prec)
            t0 = time.time()
            eng = sess.engine()
            _sync(torch, dev)
            run["engine_s"] = time.time() - t0
            got, st, run["warm_s"], run["batch_s"] = run_batch(
                args, dev, sess, qb)
            run["qps"] = len(qb) / run["batch_s"]
            run.update(stats_shards=st.shards, knn_rounds=st.knn_rounds,
                       rows_scanned=st.rows_scanned,
                       knn_exact_fallbacks=st.knn_exact_fallbacks,
                       mp_scanned=st.mp_scanned, mp_rescued=st.mp_rescued,
                       vr_routes=sorted(k for k, _, _ in st.stage_samples
                                        if k.startswith("vr:")))
            got_vr = None
            if prec == "fp32":
                got_vr, st_vr = sess.plan(vb).execute()
                run["vr_batch"] = dict(
                    routes=sorted(k for k, _, _ in st_vr.stage_samples
                                  if k.startswith("vr:")),
                    vr_tiles_scanned=st_vr.vr_tiles_scanned,
                    vr_dense_fallbacks=st_vr.vr_dense_fallbacks)
            _sync(torch, dev)
            run["launches"] = _counters(kmods)
            if dev.type == "cuda":
                run["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            ties, bad = [], []
            for i, (a, b) in enumerate(zip(got, single[prec])):
                if not np.array_equal(a, b):
                    (ties if tie_at_kth(Q, np, col, qb[i], a, b)
                     else bad).append(i)
            run["ties_at_kth"] = ties
            if st.shards != s:
                return f"sharded: stats.shards {st.shards} at S = {s}", info
            if bad:
                return (f"sharded S={s} {prec}: query {bad[0]} differs from "
                        f"the single-device rows: {got[bad[0]][:10]} vs "
                        f"{single[prec][bad[0]][:10]}"), info
            bad = [i for i, t in enumerate(truths)
                   if not np.array_equal(got[i], t)
                   and not tie_at_kth(Q, np, col, qb[i], got[i], t)]
            if bad:
                return f"sharded S={s} {prec}: query {bad[0]} differs " \
                       f"from the oracle", info
            if got_vr is not None:
                vrb = run["vr_batch"]
                if vrb["vr_tiles_scanned"] <= 0 or vrb["vr_dense_fallbacks"]:
                    return f"sharded S={s}: the V.R batch did not take " \
                           f"the sharded tile route: {vrb}", info
                bad = [i for i, (a, b, t) in enumerate(
                    zip(got_vr, single_vr, vr_truth))
                    if not (np.array_equal(a, b) and np.array_equal(a, t))]
                if bad:
                    return f"sharded S={s}: V.R query {bad[0]} differs " \
                           f"from the single-device rows or the oracle", \
                           info
            need = ("pairwise_sq_l2",
                    "topk_l2_masked" if prec == "fp32" else "quant_lb2")
            if min(run["launches"][n] for n in need) <= 0:
                return f"sharded S={s} {prec}: a kernel of the run never " \
                       f"launched: {run['launches']}", info
            key = p._engine_key(sess.beam, sess.tile, prec, s)
            del eng
            p._engines.pop(key, None)
    finally:
        p.cost_model = saved_model
        for k in [k for k in p._sessions if k[3] is not None]:
            p._sessions.pop(k)
        for s, prec, _ in SHARD_RUNS:
            p._engines.pop(p._engine_key(16, 128, prec, s), None)
    info["launches"] = {n: sum(r["launches"][n] for r in info["runs"])
                        for n in info["runs"][0]["launches"]}
    if dev.type == "cuda":
        info["peak_gib"] = max(r["peak_gib"] for r in info["runs"])
    return None, info


def drive_rollback(args, dev, sp, sbatch):
    """Generations on path (b)'s small platform: a save, then 500 rows
    appended and folded (the next generation) and a second save; the
    batch's rows differ between them. ``rollback_platform`` gives a fresh
    platform on the card with the first generation's rows and flips
    ``CURRENT`` back; ``MQRLD.rollback()`` of the live platform does the
    same through ``snapshot_dir``. Returns (error or None, info)."""
    import tempfile

    import numpy as np
    from repro_torch.core import persist

    rng = np.random.default_rng(args.seed + 10)
    centers = blob_centers(args)
    first, _ = sp.session().plan(sbatch).execute()
    info = {}
    with tempfile.TemporaryDirectory() as d:
        persist.save_platform(sp, d)
        lab = rng.integers(0, 12, 500)
        sp.append(numeric={"price": rng.uniform(0, 100, 500).astype(
            np.float32)}, vector={"v": (centers[lab] + rng.normal(
                size=(500, args.dim))).astype(np.float32)}, fold=False)
        sp.fold()
        second, _ = sp.session().plan(sbatch).execute()
        persist.save_platform(sp, d)
        info["generations"] = persist.list_generations(d)
        info["current_before"] = persist.current_generation(d)
        info["second_differs"] = sum(
            not np.array_equal(a, b) for a, b in zip(first, second))
        t0 = time.time()
        back = persist.rollback_platform(
            d, device=None if dev.type == "cuda" else dev)
        info["rollback_s"] = time.time() - t0
        info["current_after"] = persist.current_generation(d)
        got, _ = back.session().plan(sbatch).execute()
        same = all(np.array_equal(a, b) for a, b in zip(got, first))
        persist._set_current(d, info["current_before"])
        info["platform_rollback_generation"] = sp.rollback()
        got2, _ = sp.session().plan(sbatch).execute()
        same2 = all(np.array_equal(a, b) for a, b in zip(got2, first))
        info["current_after_platform_rollback"] = \
            persist.current_generation(d)
    info.update(first_rows_again=same, platform_rows_again=same2)
    if not (same and same2) or info["second_differs"] == 0 \
            or info["current_after"] != info["current_before"] - 1:
        return f"rollback: {info}", info
    return None, info


# -------------------------------------------------------- serving path
SERVE_REQUESTS = 384     # cut from 1,024, then 512, for the time limit
#                          (PERF.md §4)
SERVE_LENGTHS = (16, 32, 64, 128)
SERVE_SAMPLE = 128       # served requests held to the oracle
SERVE_APPEND = 64        # prompts appended by token, then served
SERVE_TRACED = 192       # requests of the traced depth-3 window: three
#                          full chunks in flight (the trace's own cost
#                          grows with its events)


def _serve_requests(np, Q, RetrievalRequest, vocab: int, seed: int):
    """``SERVE_REQUESTS`` requests, prompts of ``SERVE_LENGTHS`` tokens in
    turn and three archetypes in turn: V.K k = 20, V.K k = 100 and
    N.R(price) + V.K k = 20."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(SERVE_REQUESTS):
        toks = rng.integers(0, vocab, SERVE_LENGTHS[i % 4]).astype(np.int32)
        kind = i % 3
        out.append(RetrievalRequest(
            tokens=toks, attr="v", k=100 if kind == 1 else 20,
            predicate=Q.NR("price", 25, 75) if kind == 2 else None))
    return out


@contextlib.contextmanager
def _stage_clock(cls, name: str, out: list):
    """Time every call of ``cls.name`` into ``out`` while inside."""
    real = getattr(cls, name)

    def timed(self, *a, **kw):
        t0 = time.time()
        try:
            return real(self, *a, **kw)
        finally:
            out.append(time.time() - t0)
    setattr(cls, name, timed)
    try:
        yield
    finally:
        setattr(cls, name, real)


def drive_serving_path(args, dev, p2, kmods, keep=None):
    """Path (i): ``RetrievalServer(batch_size=64)`` over (h)'s loaded
    platform, ``EmbeddingServer(mqrld-embedder-100m)`` at full size in
    bf16 (its forward on its own stream) and a fixed ``--seed`` 768 ->
    512 projection, scaled once so that projected queries of the first
    64 prompts have the table's mean row norm. ``SERVE_REQUESTS`` requests
    (``_serve_requests``) served at pipeline depth 1 in fp32 and at depth
    1 and 3 in int8: rows identical request by request across the three,
    and ``SERVE_SAMPLE`` sampled requests equal to the oracle of the
    server's own query. Then ``append(tokens=...)`` of
    ``SERVE_APPEND`` prompts, served as queries in the same order: each
    returns its own appended row first. Reports the sustained requests
    per second, per-chunk embed / dispatch / epilogue seconds, and a
    ``torch.profiler`` trace of a depth-3 window of ``SERVE_TRACED``
    requests. The embedder and projection go into ``keep`` (a dict) for
    path (j). Returns (error or None, info)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import query as Q
    from repro_torch.core.planner import ExecutablePlan, PendingExecution
    from repro_torch.serve.engine import (EmbeddingServer, RetrievalRequest,
                                          RetrievalServer)

    info = {}
    cfg = get_config("mqrld-embedder-100m")
    t0 = time.time()
    emb = EmbeddingServer(cfg, seed=args.seed,
                          device=None if dev.type == "cuda" else dev)
    _sync(torch, dev)
    info["embedder_init_s"] = time.time() - t0
    reqs = _serve_requests(np, Q, RetrievalRequest, cfg.vocab_size,
                           args.seed + 11)
    rng = np.random.default_rng(args.seed + 12)
    w = (rng.normal(size=(cfg.d_model, args.dim))
         / math.sqrt(cfg.d_model)).astype(np.float32)
    calib = np.concatenate([emb.embed(np.stack([r.tokens for r in reqs[j::4][
        :16]])) for j in range(4)])
    table_norm = float(np.linalg.norm(p2.view().vector["v"], axis=1).mean())
    w *= np.float32(table_norm / np.linalg.norm(calib @ w, axis=1).mean())
    info["table_mean_norm"] = table_norm

    def project(e):
        return np.asarray(e, np.float32) @ w
    if keep is not None:
        keep.update(embedder=emb, project=project, vocab=cfg.vocab_size)

    def server(prec, depth):
        return RetrievalServer(p2, emb, batch_size=64, project=project,
                               precision=prec, pipeline_depth=depth)

    # warm: the embedder at each prompt length and one chunk of each
    # archetype per precision
    for prec in ("fp32", "int8"):
        server(prec, 1).serve(reqs[:192])
    _sync(torch, dev)
    _reset(kmods)
    runs = {}
    for label, prec, depth in (("fp32 depth 1", "fp32", 1),
                               ("int8 depth 1", "int8", 1),
                               ("int8 depth 3", "int8", 3)):
        stages = {"embed": [], "execute": [], "dispatch": [], "epilogue": []}
        srv = server(prec, depth)
        with _stage_clock(RetrievalServer, "_embed_tokens",
                          stages["embed"]), \
                _stage_clock(ExecutablePlan, "execute", stages["execute"]), \
                _stage_clock(ExecutablePlan, "execute_async",
                             stages["dispatch"]), \
                _stage_clock(PendingExecution, "materialize",
                             stages["epilogue"]):
            t0 = time.time()
            res = srv.serve(reqs)
            _sync(torch, dev)
            wall = time.time() - t0
        st = srv.stats()
        runs[label] = res
        info[label] = dict(
            wall_s=wall, requests_per_s=len(reqs) / wall,
            chunks=st["batches"], served=st["served"], shed=st["shed"],
            **{f"{k}_s_per_chunk": (float(np.median(v)) if v else None)
               for k, v in stages.items()},
            **{f"{k}_s_total": float(sum(v)) for k, v in stages.items()})
        if st["served"] != len(reqs) or st["shed"]:
            return f"serving {label}: {st}", info
    info["launches"] = _counters(kmods)
    base = runs["fp32 depth 1"]
    for label in ("int8 depth 1", "int8 depth 3"):
        bad = [i for i, (a, b) in enumerate(zip(runs[label], base))
               if not np.array_equal(a.rows, b.rows)]
        info[f"{label} rows differ from fp32 depth 1"] = len(bad)
        if bad:
            return f"serving {label}: request {bad[0]}'s rows differ " \
                   f"from fp32 at depth 1", info
    sample = np.random.default_rng(args.seed + 13).choice(
        len(reqs), SERVE_SAMPLE, replace=False)
    t0 = time.time()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        truths = list(ex.map(p2.oracle, [base[i].query for i in sample]))
    # a top-level V.K comes back in the oracle's order; the server ranks
    # the rows of a predicate request by distance itself, so those are
    # held to the oracle as sets
    bad = [int(i) for i, t in zip(sample, truths)
           if not (np.array_equal(base[i].rows, t)
                   if reqs[i].predicate is None else
                   np.array_equal(np.sort(base[i].rows), np.sort(t)))]
    info["oracle_s"] = time.time() - t0
    info["oracle_mismatches"] = len(bad)
    if bad:
        return f"serving: request {bad[0]} differs from the oracle", info

    def traced():
        server("int8", 3).serve(reqs[:SERVE_TRACED])
    t0 = time.time()
    info["depth3_trace"] = _trace(torch, traced, 1, cpu=False)
    info["depth3_trace"]["trace_s"] = time.time() - t0

    srv = server("int8", 3)
    toks = list(np.random.default_rng(args.seed + 14).integers(
        0, cfg.vocab_size, (SERVE_APPEND, 32)).astype(np.int32))
    m0 = p2.n_base + p2.n_delta
    t0 = time.time()
    srv.append(tokens=toks, attr="v", numeric={"price": np.full(
        SERVE_APPEND, 50.0, np.float32)}, fold=False)
    info["append_s"] = time.time() - t0
    got = srv.serve([RetrievalRequest(tokens=t, attr="v", k=20)
                     for t in toks])
    first = [int(r.rows[0]) for r in got]
    info["appended_first"] = sum(f == m0 + j for j, f in enumerate(first))
    if first != list(range(m0, m0 + SERVE_APPEND)):
        return f"serving: appended rows are not their prompts' first " \
               f"rows: {first[:8]} (want from {m0})", info
    return None, info


# ------------------------------------------------ re-optimization path
REOPT_CHUNK = 64          # requests a poll: one full micro-batch
REOPT_SAMPLE = 32         # served requests held to the oracle a checkpoint
REOPT_APPEND = 2500       # rows whose append marks the background fold
REOPT_ROLLBACK_ROWS = 256  # rows appended after the re-optimizing swap
REOPT_MAX_POLLS = 60      # bound on the serving loop while tuning


def _reopt_chunk(np, Q, RetrievalRequest, vocab: int, rng, kind: int):
    """One full micro-batch of one of ``_serve_requests``' archetypes
    (0: V.K k = 20, 1: V.K k = 100, 2: N.R(price) + V.K k = 20), prompts
    of ``SERVE_LENGTHS`` tokens in turn."""
    return [RetrievalRequest(
        tokens=rng.integers(0, vocab, SERVE_LENGTHS[i % 4]).astype(np.int32),
        attr="v", k=100 if kind == 1 else 20,
        predicate=Q.NR("price", 25, 75) if kind == 2 else None)
        for i in range(REOPT_CHUNK)]


def drive_reopt_path(args, dev, p, keep, kmods):
    """Path (j): online re-optimization on (h)'s live platform (215,000
    folded rows plus ``PERSIST_ROWS`` live delta rows, prepared with
    ``min_leaf=64, max_leaf=1024``, which the beside-build reproduces).
    ``RetrievalServer(batch_size=64)`` in fp32 at depth 1 with (i)'s
    embedder and projection; ``fold_mode = "background"`` with an
    ``auto_fold_ratio`` that the append of ``REOPT_APPEND`` rows crosses,
    so the attached ``ReoptController``'s first steps build, warm and swap
    a fold generation of 220,000 rows between micro-batches. Then it
    tunes on 1,024-row shadows, builds the winner's generation at full
    size beside the serving one, warms and swaps it. If the tuner finds
    no improvement (its choice rests partly on wall time), the path
    builds the best candidate's generation itself, warms it through the
    controller and swaps it between micro-batches: one full-size
    beside-build either way. Then ``REOPT_ROLLBACK_ROWS`` rows are
    appended and served, and ``p.rollback()`` restores the fold
    generation in memory with them. At four checkpoints (before the fold
    swap, after it, after the re-optimizing swap, after the rollback)
    ``REOPT_SAMPLE`` served requests are held to the oracle by logical
    row identity, through ``view().row_ids`` captured when their batch
    ran. Returns (error or None, info)."""
    import numpy as np
    import torch
    from repro_torch.core import engine as teng
    from repro_torch.core import query as Q
    from repro_torch.core.reopt import ReoptConfig, ReoptController
    from repro_torch.serve.engine import RetrievalRequest, RetrievalServer

    info = {"steps": [], "polls": []}
    rng = np.random.default_rng(args.seed + 20)
    req_rng = np.random.default_rng(args.seed + 21)
    centers = blob_centers(args)
    srv = RetrievalServer(p, keep["embedder"], batch_size=REOPT_CHUNK,
                          project=keep["project"], precision="fp32",
                          pipeline_depth=1)
    sess = srv.session
    built = []
    real_init = teng.HybridEngine.__init__

    def counted_init(self, *a, **kw):
        built.append(1)
        real_init(self, *a, **kw)
    served = {"before fold swap": [], "after fold swap": [],
              "after reopt swap": [], "after rollback": []}

    def poll_chunk(phase, kind=None):
        """Submit one chunk (the archetypes in turn unless ``kind`` is
        given): its last submit fills the group and runs the micro-batch.
        Then one ``poll()``, an idle point, takes one controller step.
        The chunk's futures are filed under ``phase`` with the view its
        batch ran on; the iteration's wall time (batch and step) is the
        serving loop's stall."""
        if kind is None:
            kind = len(info["polls"]) % 3
        view = p.view()
        t0 = time.time()
        futs = [srv.submit(r) for r in _reopt_chunk(
            np, Q, RetrievalRequest, keep["vocab"], req_rng, kind)]
        if not all(f.done() for f in futs):
            raise RuntimeError("reopt: a full group did not run at submit")
        n = srv.poll()
        _sync(torch, dev)
        info["polls"].append(time.time() - t0)
        if n:
            raise RuntimeError(f"reopt: an idle poll served {n}")
        served[phase] += [(f, view) for f in futs]

    ref = p.view()                 # 217,500 rows: (j)'s first epoch
    ref_pos = np.argsort(ref.row_ids)
    probe = np.random.default_rng(args.seed + 23).choice(
        ref.n_rows, 1024, replace=False)

    def rows_kept(view):
        """Every logical row of ``view`` once, and the probed rows of
        (j)'s first epoch with their content unchanged: no swap, fold or
        rollback lost, doubled or altered a row."""
        ids = view.row_ids
        if not np.array_equal(np.sort(ids), np.arange(len(ids))):
            return False
        pos = np.argsort(ids)[probe]
        return (np.array_equal(view.vector["v"][pos],
                               ref.vector["v"][ref_pos[probe]])
                and np.array_equal(view.numeric["price"][pos],
                                   ref.numeric["price"][ref_pos[probe]]))

    def check(phase):
        """``REOPT_SAMPLE`` of the phase's served requests against the
        oracle (``execute_bruteforce``, as ``p.oracle``) over the view
        their batch ran on, by logical row identity through that view's
        ``row_ids``: a top-level V.K in the oracle's order, a predicate
        request (whose rows the server ranks by distance itself) as a
        set. Exactly equal distances order by physical row, which a
        re-permutation changes, so each truth is taken at its own epoch.
        Every view the phase served from must keep every row."""
        got = served[phase]
        pick = np.random.default_rng(args.seed + 22).choice(
            len(got), min(REOPT_SAMPLE, len(got)), replace=False)
        jobs = [(got[i][0].result(), got[i][1]) for i in pick]
        t0 = time.time()
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) \
                as ex:
            truths = list(ex.map(
                lambda j: Q.execute_bruteforce(j[1], j[0].query), jobs))
        bad = []
        for i, (res, view), t in zip(pick, jobs, truths):
            have = [int(view.row_ids[r]) for r in res.rows]
            want = [int(view.row_ids[r]) for r in t]
            if not (have == want if isinstance(res.query, Q.VK)
                    else sorted(have) == sorted(want)):
                if not bad:
                    info[f"first mismatch {phase}"] = dict(
                        request=int(i), query=type(res.query).__name__,
                        same_set=sorted(have) == sorted(want),
                        served=have, oracle=want)
                bad.append(int(i))
        views = list({id(v): v for _, v in got}.values())
        lost = sum(not rows_kept(v) for v in views)
        info[f"oracle {phase}"] = dict(checked=len(pick), mismatches=len(bad),
                                       served=len(got), views=len(views),
                                       views_losing_rows=lost,
                                       oracle_s=time.time() - t0)
        got.clear()                # the views are full-size copies
        if lost:
            return f"reopt {phase}: a view lost or altered rows"
        return None if not bad else \
            f"reopt {phase}: request {bad[0]} differs from the oracle"

    # warm: the fp32 engine over the live delta, each archetype once
    t0 = time.time()
    for _ in range(3):
        poll_chunk("before fold swap")
    info["warm_s"] = time.time() - t0
    served["before fold swap"].clear()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset(kmods)
    teng.HybridEngine.__init__ = counted_init
    try:
        p.fold_mode = "background"
        p.auto_fold_ratio = 1.5 * REOPT_APPEND / p.n_base
        lab = rng.integers(0, 12, REOPT_APPEND)
        srv.append(numeric={"price": rng.uniform(0, 100, REOPT_APPEND)
                            .astype(np.float32)},
                   vectors={"v": (centers[lab] + rng.normal(
                       size=(REOPT_APPEND, args.dim))).astype(np.float32)})
        info.update(fold_due=p.fold_due, n_base=p.n_base,
                    n_delta=p.n_delta)
        if not p.fold_due:
            return "reopt: the append did not mark the background fold", \
                info
        ctl = ReoptController(p, config=ReoptConfig(
            interval_s=0, min_queries=64, sample_rows=1024,
            max_workload=16, seed=args.seed,
            prewarm_sizes=(1, 2, 4, 8, 16, 32, 64)))
        srv.attach_reopt(ctl)
        real_step = ctl.step

        def timed_step():
            t0 = time.time()
            kind = real_step()
            _sync(torch, dev)
            info["steps"].append([kind, time.time() - t0])
            return kind
        ctl.step = timed_step

        # the background fold: built, warmed and swapped between batches
        phase = "before fold swap"
        while ctl.n_folds == 0 and len(info["polls"]) < REOPT_MAX_POLLS:
            poll_chunk(phase)
        if ctl.n_folds != 1:
            return f"reopt: no fold swap: {info['steps']}", info
        info["folded"] = dict(n_base=p.n_base, n_delta=p.n_delta,
                              generation=p.generation)
        err = check(phase)
        if err:
            return err, info

        # tuning on shadows, then the full-size beside-build
        phase = "after fold swap"
        t_loop = time.time()
        n0 = srv.n_served
        while ctl.state != "won" and len(info["polls"]) < REOPT_MAX_POLLS:
            poll_chunk(phase)
            if ctl.history and ctl.history[-1].kind == "no-improvement":
                break
        if ctl.state == "won":      # the controller builds, warms, swaps
            while ctl.n_swaps == 0 and \
                    len(info["polls"]) < REOPT_MAX_POLLS:
                poll_chunk(phase)
            info["swapped_by"] = "controller"
        info["loop_requests_per_s"] = (srv.n_served - n0) / (
            time.time() - t_loop)
        srv.reopt = None            # no further cycle: one build a run
        if ctl.n_swaps == 0:
            last = ctl.history[-1] if ctl.history else None
            if last is None or last.kind != "no-improvement":
                return f"reopt: the tuner stopped at {ctl.state}: " \
                    f"{info['steps']}", info
            t0 = time.time()
            gen = p.build_generation(**last.params)
            info["steps"].append(["built", time.time() - t0])
            t0 = time.time()
            ctl._warm_generation(gen)
            _sync(torch, dev)
            info["steps"].append(["warmed", time.time() - t0])
            t0 = time.time()
            p.swap(gen)
            info["steps"].append(["swapped", time.time() - t0])
            info["swapped_by"] = "path (j), after no-improvement"
        info["history"] = [dict(kind=h.kind, gen_id=h.gen_id,
                                params=h.params, baseline=h.baseline,
                                best=h.best, sc_before=h.sc_before,
                                sc_after=h.sc_after) for h in ctl.history]
        info["warm_errors"] = list(ctl.warm_errors)
        if ctl.warm_errors:
            return f"reopt: warm-up errors {ctl.warm_errors}", info
        err = check(phase)
        if err:
            return err, info

        # the first batch after the swap, of the hottest signature
        phase = "after reopt swap"
        hits, n_built = sess.cache_hits, len(built)
        warm_engine = p._engines.get(p._engine_key(sess.beam, sess.tile,
                                                   sess.precision))
        poll_chunk(phase, kind=0)
        info["first_batch_after_swap"] = dict(
            plan_cache_hit=sess.cache_hits == hits + 1,
            engines_built=len(built) - n_built,
            prewarmed_engine_used=warm_engine is not None and p._engines.get(
                p._engine_key(sess.beam, sess.tile, sess.precision))
            is warm_engine)
        err = check(phase)
        if err:
            return err, info
        # rows written after the swap, which the rollback must keep: the
        # chunk served on them is checked with the rollback's (the
        # rollback changes no row, so one oracle serves both)
        phase = "after rollback"
        lab = rng.integers(0, 12, REOPT_ROLLBACK_ROWS)
        srv.append(numeric={"price": rng.uniform(
            0, 100, REOPT_ROLLBACK_ROWS).astype(np.float32)},
            vectors={"v": (centers[lab] + rng.normal(
                size=(REOPT_ROLLBACK_ROWS, args.dim))).astype(np.float32)})
        poll_chunk(phase, kind=0)

        # the in-memory rollback to the fold generation
        before = (p.n_base, p.n_delta)
        t0 = time.time()
        p.rollback()
        t_rb = time.time() - t0
        p.engine(precision="fp32")
        _sync(torch, dev)
        info["rollback"] = dict(rollback_s=t_rb,
                                engine_rebuild_s=time.time() - t0 - t_rb,
                                rows_before=before,
                                rows_after=(p.n_base, p.n_delta),
                                generation=p.generation)
        if p.n_base + p.n_delta != sum(before):
            return f"reopt: rollback changed the row count: " \
                   f"{info['rollback']}", info
        poll_chunk(phase)
        err = check(phase)
        if err:
            return err, info
    finally:
        teng.HybridEngine.__init__ = real_init
    info["launches"] = _counters(kmods)
    if dev.type == "cuda":     # two engines resident at each warm-up
        info["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # the longest the serving loop waited between two micro-batches: a
    # poll's batch and step, or the path's own build, warm-up and swap
    info["longest_stall_s"] = max(info["polls"]
                                  + [sec for _, sec in info["steps"]])
    info["stats"] = {k: v for k, v in srv.stats().items()
                     if k != "by_signature"}
    return None, info


# ------------------------------------------------------------ model paths
def _rel(torch, a, b) -> float:
    """||a - b|| / ||b|| over all rows (Frobenius)."""
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def drive_embedding_path(args, dev):
    """``EmbeddingServer(mqrld-embedder-100m)`` at full size (12 layers,
    768 wide, 12 heads padded to 16) over 64 token rows of length 128
    drawn from ``--seed``; then 4 of those rows again with the same
    weights on the CPU, in bf16 (the served type) and in fp32, and on the
    card in fp32. Tolerance: the card's embeddings differ from the CPU's,
    in bf16 and in fp32, by no more (relative L2 over the 4 rows) than the
    CPU's own bf16 embeddings differ from its fp32 ones: random weights
    drawn by the reference's law make the attention nearly one-hot (score
    spreads in the tens), so a rounding anywhere can move a pooled
    embedding by whole percents. Returns (ok, info)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.serve.engine import EmbeddingServer

    cfg = get_config("mqrld-embedder-100m")
    resident = _resident_gib(torch, dev)
    rng = np.random.default_rng(args.seed + 4)
    toks = rng.integers(0, cfg.vocab_size, (64, 128)).astype(np.int32)
    t0 = time.time()
    srv = EmbeddingServer(cfg, device=None if dev.type == "cuda" else dev,
                          seed=args.seed)
    _sync(torch, dev)
    t_init = time.time() - t0
    t0 = time.time()
    srv.embed(toks)
    t_first = time.time() - t0
    t0 = time.time()
    emb = srv.embed(toks)
    t_embed = time.time() - t0
    tree = params_to_numpy(cfg, srv.params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    few = toks[:4]
    cpu16 = EmbeddingServer(cfg, params_from_numpy(cfg, tree, "cpu"),
                            device="cpu").embed(few)
    cpu32 = EmbeddingServer(cfg32, params_from_numpy(cfg32, tree, "cpu"),
                            device="cpu").embed(few)
    card32 = EmbeddingServer(cfg32, params_from_numpy(cfg32, tree, dev),
                             device=dev).embed(few)
    gap = _rel(torch, cpu16, cpu32)
    r16, r32 = _rel(torch, emb[:4], cpu16), _rel(torch, card32, cpu32)
    shape_ok = emb.shape == (64, cfg.d_model) and bool(np.isfinite(emb).all())
    ok = shape_ok and r16 <= gap and r32 <= gap
    return ok, dict(
        resident_gib_before=resident,
        shape=list(emb.shape), finite=shape_ok, init_s=t_init,
        first_embed_s=t_first, embed_s=t_embed,
        rows_per_s=len(toks) / t_embed, rel_card_cpu_bf16=r16,
        rel_card_cpu_fp32=r32, rel_cpu_bf16_fp32=gap,
        scale=float(np.abs(cpu32).max()))


def _resident_gib(torch, dev) -> float:
    """Device memory still allocated (tensors alive) before a path."""
    return torch.cuda.memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else 0.0


def _device_spans(prof):
    """(start ns, end ns, stream) of every device activity (kernels,
    copies, fills) in a finished ``torch.profiler`` run; from the
    profiler's function events, without the stream, where its raw events
    are not exposed."""
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.start_ns(), e.start_ns() + e.duration_ns(),
                 e.device_resource_id()) for e in raw
                if str(e.device_type()).endswith("CUDA")]
    except AttributeError:
        return [(int(e.time_range.start * 1e3), int(e.time_range.end * 1e3),
                 None) for e in prof.events()
                if str(e.device_type).endswith("CUDA")]


def _trace(torch, fn, steps: int, classes=None, cpu: bool = True):
    """``fn`` under ``torch.profiler`` (CPU and CUDA activity; CUDA alone
    with ``cpu=False``, for a window of many small kernels, whose CPU
    operator events would cost the tracer minutes to parse): the host
    wall time and the summed device time of its kernels, per step; the
    device's busy time, the union of its activity intervals over all
    streams (kernels on two streams that overlap count once), and its
    share of the wall time; the summed time and event count per stream;
    and the six kernels with the most device time; with ``classes`` ({class: regex on the kernel's
    name}, first match wins, the rest "other"), each class's device ms per
    step and share of the device time. The tracer slows the host side, so
    the busy share here is a lower bound; set it against the untraced
    times."""
    from torch.profiler import ProfilerActivity, profile
    fn()                                      # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    # the kernels themselves (device events), not the operators that
    # launched them, so no time is counted twice
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    spans = _device_spans(prof)
    busy_ns, by_stream = 0, {}
    end = None
    for a, b, stream in sorted(spans):
        st = by_stream.setdefault(str(stream), [0, 0])
        st[0] += b - a
        st[1] += 1
        if end is None or a >= end:
            busy_ns += b - a
            end = b
        elif b > end:
            busy_ns += b - end
            end = b
    out = dict(
        wall_ms_per_step=wall * 1e3 / steps,
        device_ms_per_step=dev_us / 1e3 / steps if events else None,
        device_busy_ms_per_step=busy_ns / 1e6 / steps if spans else None,
        device_busy_share=busy_ns / 1e9 / wall if spans else None,
        device_events=len(spans),
        streams={k: dict(ms_per_step=v[0] / 1e6 / steps, events=v[1])
                 for k, v in by_stream.items()},
        top=[(e.key[:60], e.self_device_time_total / 1e3 / steps,
              e.count / steps) for e in top])
    if classes is not None:
        us = dict.fromkeys([*classes, "other"], 0.0)
        for e in events:
            c = next((c for c, rx in classes.items()
                      if re.search(rx, e.key)), "other")
            us[c] += e.self_device_time_total
        out["by_class"] = {c: dict(ms_per_step=u / 1e3 / steps,
                                   share=u / dev_us if dev_us else None)
                           for c, u in us.items()}
    return out


def _vs_fp64(torch, ref, q, k, v, got, causal: bool, window: int):
    """The errors against the exact (fp64) result, one batch row at a
    time, of the kernel's output ``got``, of the plain version, and of the
    plain version on q and k with the hd axis shuffled (the same exact
    function, another fp32 summation order: how far the plain version's
    own rounding spreads): {name: (max |error|, root mean square)}, and
    under "reordered_vs_plain" the same of their difference."""
    hd = q.shape[3]
    mask = _keep(torch, q.shape[1], causal, window, q.device)
    perm = torch.randperm(hd, generator=torch.Generator().manual_seed(0))
    perm = perm.to(q.device)
    top = {n: 0.0 for n in ("kernel", "plain", "reordered",
                            "reordered_vs_plain")}
    sq = dict(top)
    for i in range(q.shape[0]):
        sl = slice(i, i + 1)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[sl].double(),
                          k[sl].double()) / math.sqrt(hd)
        w = torch.softmax(torch.where(mask, sc, -1e30), dim=-1)
        del sc
        exact = torch.einsum("bhqk,bkhd->bqhd", w, v[sl].double())
        del w
        outs = {"kernel": got[sl],
                "plain": ref.flash_attention(q[sl], k[sl], v[sl],
                                             causal=causal, window=window),
                "reordered": ref.flash_attention(
                    q[sl][..., perm].contiguous(),
                    k[sl][..., perm].contiguous(), v[sl],
                    causal=causal, window=window)}
        diffs = {n: o.double() - exact for n, o in outs.items()}
        diffs["reordered_vs_plain"] = diffs["reordered"] - diffs["plain"]
        for n, d in diffs.items():
            top[n] = max(top[n], float(d.abs().max()))
            sq[n] += float(d.square().sum())
        del exact, outs, diffs
    return {n: (top[n], math.sqrt(sq[n] / got.numel())) for n in top}


# fp32 launches of a real prefill are held to the exact (fp64) result:
# each launch's root mean square error within FP64_RATIO times the plain
# version's, and each launch's largest error within FP64_RATIO times the
# plain version's largest over the path plus 2e-5 (see held_flash)
FP64_RATIO = 1.25


@contextlib.contextmanager
def held_flash(torch, fa, ref, route: str, score_err: bool, rows=None):
    """Inside the block every call of ``fa.flash_attention_cuda`` is held
    to the plain version (``flash_check``) and must launch the ``route``
    kernel. ``score_err`` marks a real prefill's random-weight scores,
    which reach hundreds: bf16 adds the scores' fp32 rounding term to its
    tolerance; fp32 is held to the exact (fp64) result instead
    (``_vs_fp64``), since at such scores that rounding alone moves the
    plain version from the exact result by more than 2e-5, and from
    itself when only its summation order changes, so no fp32
    implementation can meet 2e-5 against it. A launch then passes here
    when its root mean square error is within ``FP64_RATIO`` times the
    plain version's (a statistic over millions of entries, steady from
    launch to launch); ``_generation_runs`` adds the largest error's
    rule over the path, since one launch's largest error is a few
    entries' and scatters widely, the plain version's against its
    reordered self as much (``_vs_fp64``'s "reordered"). Yields the
    list it fills, one (shape, type, ok, max |error| against the plain
    version, entries over the type's tolerance without the scores' term,
    routed, for fp32 with ``score_err`` ``_vs_fp64``'s errors, else None,
    the window) per call. ``rows``: ``flash_check``'s blocks of queries
    (bf16 only; fp32 with ``score_err`` holds the whole (S, S) scores)."""
    checks, launch = [], fa.flash_attention_cuda

    def checked(q, k, v, *, causal=True, window=0):
        before = fa.launches_by_route[route]
        out = launch(q, k, v, causal=causal, window=window)
        routed = fa.launches_by_route[route] == before + 1
        ok, err, over = flash_check(torch, ref, q, k, v, out, causal,
                                    window, score_err=score_err, rows=rows)
        exact = None
        if q.dtype == torch.float32 and score_err:
            exact = _vs_fp64(torch, ref, q, k, v, out, causal, window)
            ok = exact["kernel"][1] <= FP64_RATIO * exact["plain"][1]
        checks.append((tuple(q.shape), str(q.dtype), ok, err, over, routed,
                       exact, window))
        return out
    fa.flash_attention_cuda = checked
    try:
        yield checks
    finally:
        fa.flash_attention_cuda = launch


def _first_divergence(a, b):
    import numpy as np
    d = np.flatnonzero(np.asarray(a) != np.asarray(b))
    return int(d[0]) if len(d) else None


def _generation_runs(torch, eng, reqs, fa, ref, route, score_err: bool,
                     alone=None):
    """Three generations of ``reqs`` on ``eng``. Run 1 holds the flash
    kernel on every layer of each real prefill to its plain version
    (``held_flash`` on ``route``; a model without the kernel, xlstm,
    passes ``route=None``) and records every step's logits; run 2 is
    timed (host clock, each batch's prefill and decode ending in a
    synchronize), with the peak device memory; then each request alone
    (check 3: the batched tokens equal them, or the step where they part
    has a top-2 margin below twice the logit difference there), or those
    of ``alone`` (request indices) where a path's time limit asks for
    fewer. Returns (ok: checks 1 and 3, every launch routed, info, the
    buckets in generate's order)."""
    import numpy as np
    vocab, max_new = eng.cfg.vocab_size, reqs[0].max_new
    lens = [len(r.prompt) for r in reqs]
    buckets = [[i for i, n in enumerate(lens) if n == m]
               for m in sorted(set(lens))]       # generate's batch order
    info = {}
    logits, greedy = [], eng._greedy
    eng._greedy = lambda lg: logits.append(lg.float().cpu()) or greedy(lg)
    try:
        with (held_flash(torch, fa, ref, route, score_err) if route
              else contextlib.nullcontext([])) as checks:
            first = eng.generate(reqs)
    finally:
        del eng._greedy     # the class's method again: no cycle holds eng
    failed = [not c[2] for c in checks]
    if route:
        info["flash_checked_launches"] = len(checks)
        info[f"flash_{route}_launches"] = sum(c[5] for c in checks)
        info["flash_max_abs_err"] = max(c[3] for c in checks)
        if score_err:
            info["flash_over_tol_without_score_term"] = sum(
                c[4] for c in checks)
        info["flash_shape"] = max(checks,
                                  key=lambda c: math.prod(c[0]))[:2]
    if checks and all(c[6] is not None for c in checks):
        ex = [c[6] for c in checks]
        worst = {n: max(e[n][0] for e in ex) for n in ex[0]}
        bound = FP64_RATIO * worst["plain"] + 2e-5
        failed = [f or e["kernel"][0] > bound for f, e in zip(failed, ex)]
        info["vs_fp64"] = dict(
            max_abs_err=worst, max_rule=bound,
            worst_launch_ratio_max={n: max(e[n][0] / e["plain"][0]
                                           for e in ex)
                                    for n in ("kernel", "reordered")},
            worst_launch_ratio_rms={n: max(e[n][1] / e["plain"][1]
                                           for e in ex)
                                    for n in ("kernel", "reordered")},
            # how many launches a rule of FP64_RATIO on each launch's own
            # largest error would fail, for the kernel and for the plain
            # version reordered
            launches_over_ratio_max={
                n: sum(e[n][0] > FP64_RATIO * e["plain"][0] + 2e-5
                       for e in ex) for n in ("kernel", "reordered")},
            launches_within_2e_5_of_plain=sum(c[4] == 0 for c in checks))
    info["flash_failed"] = sum(failed)
    step = {}                                 # (request, t) -> logits row
    for bi, rows in enumerate(buckets):
        for t in range(max_new):
            for j, i in enumerate(rows):
                step[i, t] = logits[bi * max_new + t][j, :vocab]

    # run 2: timed
    torch.cuda.reset_peak_memory_stats()
    timed = eng.generate(reqs)
    info["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    info["buckets"] = [dict(
        prompt=lens[rows[0]], batch=len(rows),
        prefill_s=timed[rows[0]].prefill_s,
        decode_ms_per_token=timed[rows[0]].decode_s / (max_new - 1) * 1e3)
        for rows in buckets]
    info["timed_tokens_equal_run1"] = all(
        np.array_equal(a.tokens, b.tokens) for a, b in zip(first, timed))

    # check 3: batched against each request alone
    ok3, info["per_request"] = True, []
    for i, r in enumerate(reqs):
        if alone is not None and i not in alone:
            continue
        logits.clear()
        eng._greedy = lambda lg: logits.append(lg.float().cpu()) \
            or greedy(lg)
        try:
            solo = eng.generate([r])[0]
        finally:
            del eng._greedy
        t = _first_divergence(first[i].tokens, solo.tokens)
        entry = {"request": i, "diverges_at": t}
        if t is not None:
            ls = logits[t][0, :vocab]
            top = torch.topk(ls, 2).values
            entry["margin"] = float(top[0] - top[1])
            entry["logit_diff"] = float((step[i, t] - ls).abs().max())
            if not entry["margin"] < 2 * entry["logit_diff"]:
                ok3 = False
        info["per_request"].append(entry)
    routed = route is None or info[f"flash_{route}_launches"] == \
        len(checks) == len(buckets) * eng.cfg.num_layers
    info["tokens_ok"] = all(r.tokens.shape == (max_new,) for r in first)
    ok = info["flash_failed"] == 0 and routed and ok3 and info["tokens_ok"]
    return ok, info, buckets


def drive_generation_path(args, dev, fa, ref):
    """``ServeEngine(llama3-8b, max_len=2080, batch_size=4)`` at full width
    and depth, random weights from ``--seed``, on 4 requests with prompts
    of 2048, 2048, 1000 and 1000 tokens and max_new = 16.

    ``_generation_runs`` with the wgmma kernel held on every layer of
    each real prefill (tolerance ``flash_check`` with the scores' term),
    each of those 64 launches on the wgmma kernel, then the 1000-token
    bucket's prefill against ``Model.forward(mode="train")`` (check 2:
    the greedy token equal wherever the dense top-2 margin exceeds 4x the
    largest logit difference). Returns (ok, info)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import GenRequest, ServeEngine

    cfg = get_config("llama3-8b")
    vocab, max_new = cfg.vocab_size, 16
    info = {"resident_gib_before": _resident_gib(torch, dev)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = ServeEngine(cfg, device=None if dev.type == "cuda" else dev,
                      max_len=2080, batch_size=4, seed=args.seed)
    _sync(torch, dev)
    info["init_s"] = time.time() - t0
    info["n_params"] = eng.model.n_params()
    info["weights_gib"] = sum(t.numel() * t.element_size() for t in
                              eng.params.parameters()) / 2 ** 30
    info["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    rng = np.random.default_rng(args.seed + 5)
    reqs = [GenRequest(rng.integers(0, vocab, n).astype(np.int32), max_new)
            for n in (2048, 2048, 1000, 1000)]
    ok13, runs, buckets = _generation_runs(torch, eng, reqs, fa, ref,
                                           "wgmma", True)
    info.update(runs)

    # check 2: prefill (flash) against the dense forward, 1000-token
    # bucket; how far rounding alone moves these logits: the dense forward
    # of the first row alone (other GEMM shapes), and with the first
    # layer's norm scale perturbed (``_dense_logits``)
    toks = np.stack([reqs[i].prompt for i in buckets[0]])
    lp, cache = eng.model.prefill(eng.params, {"tokens": toks}, eng.max_len)
    lp = lp[:, -1, :vocab].float()
    ld = _dense_logits(torch, eng, toks)
    ok2, info["prefill_vs_dense"] = _greedy_vs(
        torch, lp, ld, _dense_logits(torch, eng, toks,
                                     eng.params.blocks[0].norm1))
    info["prefill_vs_dense"]["dense_alone_vs_batched_max_logit_diff"] = \
        float((_dense_logits(torch, eng, toks[:1])[0] - ld[0]).abs().max())

    # where the time goes: one prefill of the 2 x 2048 bucket and four
    # decode steps on the 1000-token cache, traced
    cur = eng._greedy(lp)[:, None]

    def decode4():
        nonlocal cache, cur
        for _ in range(4):
            lg, cache = eng.model.decode(eng.params, cache, cur)
            cur = eng._greedy(lg[:, -1])[:, None]
    info["decode_trace"] = _trace(torch, decode4, 4)
    del cache
    big = np.stack([reqs[i].prompt for i in buckets[1]])
    info["prefill_trace"] = _trace(torch, lambda: eng.model.prefill(
        eng.params, {"tokens": big}, eng.max_len), 1)
    del eng
    return ok13 and ok2, info


def drive_fp32_generation_path(args, dev, fa, ref):
    """The SIMT flash kernel's serving path: ``ServeEngine`` on reduced
    llama3-8b in fp32 (every fp32 input takes the SIMT route), 4 requests
    with prompts of 1000, 1000, 300 and 40 tokens and 6 new tokens each.
    Every flash launch is held to the plain version (``flash_check``, fp32
    tolerance) and must take the SIMT kernel, and the tokens must equal
    those of the same weights on the CPU (fp32 on both sides; the reduced
    model is not chaotic). Returns (ok, info)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import params_from_numpy, params_to_numpy
    from repro_torch.serve.engine import GenRequest, ServeEngine

    cfg = dataclasses.replace(get_config("llama3-8b").reduced(),
                              dtype="float32")
    eng = ServeEngine(cfg, device=dev, max_len=1024, batch_size=4,
                      seed=args.seed)
    cpu = ServeEngine(cfg, params_from_numpy(
        cfg, params_to_numpy(cfg, eng.params), "cpu"), device="cpu",
        max_len=1024, batch_size=4)
    rng = np.random.default_rng(args.seed + 7)
    reqs = [GenRequest(rng.integers(1, cfg.vocab_size, size=n)
                       .astype(np.int32), 6) for n in (1000, 1000, 300, 40)]
    with held_flash(torch, fa, ref, "simt", False) as checks:
        card = eng.generate(reqs)
    host = cpu.generate(reqs)
    equal = [bool(np.array_equal(a.tokens, b.tokens))
             for a, b in zip(card, host)]
    ok = bool(checks) and all(c[2] and c[5] for c in checks) and all(equal)
    return ok, dict(
        num_layers=cfg.num_layers, head_dim=cfg.head_dim,
        flash_checked_launches=len(checks),
        flash_simt_launches=sum(c[5] for c in checks),
        flash_failed=sum(not c[2] for c in checks),
        flash_max_abs_err=max((c[3] for c in checks), default=None),
        flash_shape=max(checks, key=lambda c: math.prod(c[0]))[:2]
        if checks else None, tokens_equal_cpu=equal)


# the kernels of an fp32 prefill by class, for its trace
PREFILL_CLASSES = {"flash (SIMT)": r"flash_fwd",
                   "GEMM": r"gemm|Gemm|GEMM|cutlass|nvjet|xmma|matmul"}


# olmo-1b's layers kept: 8 of 16, cut for the time limit (PERF.md §4)
OLMO_LAYERS = 8


def drive_olmo_fp32_path(args, dev, fa, ref):
    """``ServeEngine(olmo-1b in fp32, max_len=2048, batch_size=4)`` at
    full width and ``OLMO_LAYERS`` of its 16 layers (d_model 2048, 16
    heads of 128, d_ff 8192, vocab 50304; published in fp32), random
    weights from ``--seed``, on 4 requests with prompts of 2032, 2032, 1000 and 1000
    tokens and 16 new tokens each (two buckets of batch 2; 2048 is the
    model's context). fp32 takes the SIMT flash kernel at hd 128.

    ``_generation_runs`` with the SIMT kernel held on every layer of each
    real prefill, each of the 24 launches on the SIMT kernel: these
    scores reach ~650, where their fp32 rounding alone moves the plain
    version ~5e-3 from the exact result, so each launch is held to the
    exact (fp64) result beside the plain version (``held_flash``,
    ``FP64_RATIO``), and the launches within the bare 2e-5 of the plain
    version are counted; then one 2 x 2032 prefill traced, its
    device time split into GEMMs, the flash kernel and the rest
    (``PREFILL_CLASSES``). A token check against the CPU is out of reach
    at this size (about 10 TFLOP of fp32 prefill); path (e) keeps one.
    Returns (ok, info)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import GenRequest, ServeEngine

    cfg = dataclasses.replace(get_config("olmo-1b"), dtype="float32",
                              num_layers=OLMO_LAYERS)
    info = {"resident_gib_before": _resident_gib(torch, dev)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = ServeEngine(cfg, device=None if dev.type == "cuda" else dev,
                      max_len=2048, batch_size=4, seed=args.seed)
    _sync(torch, dev)
    info["init_s"] = time.time() - t0
    info["n_params"] = eng.model.n_params()
    info["weights_gib"] = sum(t.numel() * t.element_size() for t in
                              eng.params.parameters()) / 2 ** 30
    rng = np.random.default_rng(args.seed + 11)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       16) for n in (2032, 2032, 1000, 1000)]
    ok, runs, buckets = _generation_runs(torch, eng, reqs, fa, ref, "simt",
                                         True)
    info.update(runs)
    big = np.stack([reqs[i].prompt for i in buckets[-1]])
    info["prefill_trace"] = _trace(torch, lambda: eng.model.prefill(
        eng.params, {"tokens": big}, eng.max_len), 1, PREFILL_CLASSES)
    del eng
    return ok, info


# ------------------------------------------------ (k) MoE, (l) hymba
# (config, layers kept, prompts, new tokens): phi3.5-moe at 8 of 32
# layers (all 32 would be 77.96 GiB of bf16 weights of the card's ~79.6;
# 24, 58.6 GiB, fit, cut to 8 for the time limit: PERF.md §4), arctic
# at 2 of 35 (51.8 GiB, full width)
MOE_RUNS = (("phi3.5-moe-42b-a6.6b", 8, (2048, 2048, 1000, 1000), 16),
            ("arctic-480b", 2, (1000, 1000), 8))
# the kernels of a bf16 prefill by class, for its trace
BF16_PREFILL_CLASSES = {"flash (wgmma)": r"flash_fwd_wgmma",
                        "GEMM": r"gemm|Gemm|GEMM|cutlass|nvjet|xmma|matmul"}
# tokens of each of (l)'s two prompts: the smallest multiple of the scan's
# 128-position chunk past the 1024 window, so every ring wraps (at 2048
# the replay alone took 36 s of the time limit)
HYMBA_PROMPT = 1152


def moe_onehot(torch, cfg, p, x, capacity_factor: float = 1.25):
    """The reference's MoE layer (``repro/models/moe.py``) as it is
    written, in plain torch: gate logits from the product in x's type,
    then an fp32 softmax; the top k largest first, the lower expert on
    ties (``lax.top_k``: a stable descending argsort here); renormalised;
    each (token, choice)'s place by an exclusive cumsum of the one-hot
    (b, s * k, e) choices, kept below ``cap``; the one-hot (b, s, e, cap)
    dispatch and combine tensors (a slot at or past ``cap`` one-hots to
    zeros, as ``jax.nn.one_hot`` does) and their einsums; arctic's dense
    branch. Returns (out, topk_i, slot, keep)."""
    from repro_torch.models.layers import mlp, silu
    b, s, _ = x.shape
    e, k, dt = cfg.num_experts, cfg.top_k, x.dtype
    cap = int(max(k, capacity_factor * k * s / e))
    probs = torch.softmax((x @ p.router.to(dt)).float(), dim=-1)
    topk_i = torch.argsort(-probs, dim=-1, stable=True)[..., :k]
    topk_p = torch.gather(probs, -1, topk_i)
    topk_p = topk_p / torch.clamp_min(topk_p.sum(-1, keepdim=True), 1e-9)
    onehot = torch.nn.functional.one_hot(topk_i, e)       # (b, s, k, e)
    flat = onehot.reshape(b, s * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(b, s, k, e)
    slot = (pos * onehot).sum(-1)
    keep = ((pos < cap) & (onehot > 0)).sum(-1) > 0
    at = (slot[..., None] == torch.arange(cap, device=x.device)).to(dt)
    disp = onehot.to(dt)[..., None] * at[..., None, :] \
        * keep[..., None, None].to(dt)                    # (b, s, k, e, cap)
    combine = (disp * topk_p.to(dt)[..., None, None]).sum(dim=2)
    xin = torch.einsum("bsec,bsd->ebcd", disp.sum(dim=2), x)
    g = torch.einsum("ebcd,edf->ebcf", xin, p.w_gate.to(dt))
    u = torch.einsum("ebcd,edf->ebcf", xin, p.w_up.to(dt))
    xout = torch.einsum("ebcf,efd->ebcd", silu(g) * u, p.w_down.to(dt))
    out = torch.einsum("bsec,ebcd->bsd", combine.float(),
                       xout.float()).to(dt)
    if cfg.dense_residual_ff:
        out = out + mlp(p.dense, x)
    return out, topk_i, slot, keep


def _dense_logits(torch, eng, toks, norm=None, **inputs):
    """The dense forward's (``mode="train"``) last-position logits of the
    prompts ``toks`` (and the model's other ``inputs``, enc-dec's
    frames); with ``norm`` (a layer's norm scale) that scale times 1 +
    2^-12 for the call (an eighth of a bf16 unit: a few of the layer's
    bf16 inputs move by one unit), to show how far rounding alone moves
    these logits."""
    vocab = eng.cfg.vocab_size
    if norm is not None:
        norm.mul_(1 + 2.0 ** -12)
    try:
        ld, _ = eng.model.forward(eng.params, {"tokens": toks, **inputs},
                                  mode="train", last_only=True)
    finally:
        if norm is not None:
            norm.div_(1 + 2.0 ** -12)
    return ld[:, -1, :vocab].float()


def _greedy_vs(torch, got, want, ld_perturbed=None):
    """``got`` logits (B, V) against ``want``: the greedy token equal
    wherever ``want``'s top-2 margin exceeds 4x the largest logit
    difference, as path (d) holds its prefill. Returns (ok, info)."""
    diff = float((got - want).abs().max())
    top = torch.topk(want, 2, dim=-1).values
    margin = (top[:, 0] - top[:, 1]).tolist()
    same = (got.argmax(-1) == want.argmax(-1)).tolist()
    ok = all(sm or m <= 4 * diff for sm, m in zip(same, margin))
    info = dict(max_logit_diff=diff, top2_margin=margin, greedy_equal=same,
                logit_std=float(want.std()))
    if ld_perturbed is not None:
        info["dense_perturbed_max_logit_diff"] = float(
            (ld_perturbed - want).abs().max())
    return ok, info


def drive_moe_path(args, dev, fa, ref, name: str, layers: int, prompts,
                   max_new: int):
    """Path (k): ``ServeEngine(<name> at ``layers`` layers, bf16,
    max_len=2080, batch_size=2)`` at full width, random weights from
    ``--seed``, on one request per prompt length in ``prompts``.

    ``_generation_runs`` with the wgmma kernel held on every layer of each
    real prefill (``flash_check`` with the scores' term) and every launch
    on the wgmma route, the timed run, and batched against per-request
    generation; the first bucket's prefill against the dense forward
    (``_greedy_vs``, with the dense forward's own spread under a 2^-12
    change of the first norm scale); then one prefill of the widest
    bucket with each layer's routing recorded (the dropped share of
    (token, choice) pairs per layer), and its first MoE layer's input held
    on the card:
    ``moe`` against ``moe_onehot`` on the same input (so the same gate
    logits), ``topk_i``, slot and keep identical and the outputs within
    2^-8 of the output's largest magnitude; then that prefill traced.
    Returns (ok, info)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer
    from repro_torch.serve.engine import GenRequest, ServeEngine

    cfg = dataclasses.replace(get_config(name), num_layers=layers)
    info = {"config": name, "layers": f"{layers} of "
            f"{get_config(name).num_layers}",
            "resident_gib_before": _resident_gib(torch, dev)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = ServeEngine(cfg, device=None if dev.type == "cuda" else dev,
                      max_len=2080, batch_size=2, seed=args.seed)
    _sync(torch, dev)
    info["init_s"] = time.time() - t0
    info["init_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    info["n_params"] = eng.model.n_params()
    info["weights_gib"] = sum(t.numel() * t.element_size() for t in
                              eng.params.parameters()) / 2 ** 30
    rng = np.random.default_rng(args.seed + 13)
    reqs = [GenRequest(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                       max_new) for n in prompts]
    ok13, runs, buckets = _generation_runs(torch, eng, reqs, fa, ref,
                                           "wgmma", True)
    info.update(runs)

    toks = np.stack([reqs[i].prompt for i in buckets[0]])
    lp, cache = eng.model.prefill(eng.params, {"tokens": toks}, eng.max_len)
    del cache
    ok2, info["prefill_vs_dense"] = _greedy_vs(
        torch, lp[:, -1, :cfg.vocab_size].float(),
        _dense_logits(torch, eng, toks),
        _dense_logits(torch, eng, toks, eng.params.blocks[0].norm1))

    # the widest bucket again: routing per layer, the first layer's input
    big = np.stack([reqs[i].prompt for i in buckets[-1]])
    routes, first = [], []
    real_route, real_moe = moe_mod.route, transformer.moe

    def recording_route(cfg_, p, x, capacity_factor=1.25):
        r = real_route(cfg_, p, x, capacity_factor)
        routes.append((r.cap, float(1 - r.keep.float().mean()),
                       int(torch.bincount(r.topk_i.reshape(-1),
                                          minlength=cfg_.num_experts)
                           .max())))
        return r

    def capturing_moe(cfg_, p, x, *a, **kw):
        if not first:
            first.append((p, x.clone()))
        return real_moe(cfg_, p, x, *a, **kw)
    moe_mod.route, transformer.moe = recording_route, capturing_moe
    try:
        eng.model.prefill(eng.params, {"tokens": big}, eng.max_len)
    finally:
        moe_mod.route, transformer.moe = real_route, real_moe
    info["routing"] = dict(
        tokens=list(big.shape), cap=routes[0][0],
        expected_choices_per_expert=cfg.top_k * big.shape[1]
        / cfg.num_experts,
        dropped_share_per_layer=[r[1] for r in routes],
        busiest_expert_choices_per_layer=[r[2] for r in routes])

    p0, x0 = first[0]
    got, _ = moe_mod.moe(cfg, p0, x0)
    r = moe_mod.route(cfg, p0, x0)
    want, ti, slot, keep = moe_onehot(torch, cfg, p0, x0)
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    same = dict(topk_i=bool(torch.equal(r.topk_i, ti)),
                slot=bool(torch.equal(r.slot, slot)),
                keep=bool(torch.equal(r.keep, keep)))
    ok4 = all(same.values()) and err <= 2.0 ** -8 * scale
    info["moe_vs_onehot_layer0"] = dict(
        identical=same, max_abs_err=err, scale=scale,
        dropped=int((~keep).sum()))
    del p0, x0, first, got, want

    info["prefill_trace"] = _trace(torch, lambda: eng.model.prefill(
        eng.params, {"tokens": big}, eng.max_len), 1, BF16_PREFILL_CLASSES)
    del eng
    info["checks"] = dict(flash_and_batched=ok13, prefill_vs_dense=ok2,
                          moe_vs_onehot=ok4)
    return ok13 and ok2 and ok4, info


def drive_hymba_path(args, dev, fa, ref):
    """Path (l): ``ServeEngine(hymba-1.5b, max_len=HYMBA_PROMPT + 16,
    batch_size=2)`` at full width and depth (32 layers, d_model 1600, 25
    heads padded to 32 of hd 64, window 1024 on 28 layers, global on every
    8th), bf16, random weights from ``--seed``, on two prompts of
    ``HYMBA_PROMPT`` tokens and 16 new tokens each. The prefill is the
    stream forward (the flash kernel, windowed and global) for the logits
    plus the replay of the prompt through decode to fill the cache; past
    1024 positions every ring buffer wraps.

    Checks: every flash launch of the stream forward held to its plain
    version (``held_flash``), all on the wgmma route, windowed and global
    layers both launched; the last prompt position's logits from the
    stream forward against the replay's last decode step and against the
    dense windowed forward (``mode="train"``), the greedy token equal
    wherever the top-2 margin exceeds 4x the largest logit difference, as
    path (d) (``_greedy_vs``; with the dense forward's own spread under a
    2^-12 change of the first norm scale). Prints the replay's seconds per
    step, the decode step's time, and one traced decode step. Returns
    (ok, info)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serve.engine import GenRequest, ServeEngine

    cfg = get_config("hymba-1.5b")
    plen, max_new, vocab = HYMBA_PROMPT, 16, cfg.vocab_size
    info = {"resident_gib_before": _resident_gib(torch, dev),
            "window": cfg.window}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = ServeEngine(cfg, device=None if dev.type == "cuda" else dev,
                      max_len=plen + max_new, batch_size=2, seed=args.seed)
    _sync(torch, dev)
    info["init_s"] = time.time() - t0
    info["n_params"] = eng.model.n_params()
    info["weights_gib"] = sum(t.numel() * t.element_size() for t in
                              eng.params.parameters()) / 2 ** 30
    rng = np.random.default_rng(args.seed + 17)
    reqs = [GenRequest(rng.integers(0, vocab, plen).astype(np.int32),
                       max_new) for _ in range(2)]

    model = eng.model
    prefill, decode = model.prefill, model.decode
    seen = {}

    def timed_prefill(params, batch, max_len):
        t0 = time.time()
        out = prefill(params, batch, max_len)
        _sync(torch, dev)
        seen["stream_s"] = time.time() - t0
        seen["stream_logits"] = out[0][:, -1, :vocab].float()
        seen["replay_t0"] = time.time()
        return out

    def recording_decode(params, cache, tokens):
        lg, cache = decode(params, cache, tokens)
        if cache.length == plen:
            _sync(torch, dev)
            seen["replay_s"] = time.time() - seen["replay_t0"]
            seen["replay_logits"] = lg[:, -1, :vocab].float()
        seen["cache"], seen["cur"] = cache, tokens
        return lg, cache
    model.prefill, model.decode = timed_prefill, recording_decode
    torch.cuda.reset_peak_memory_stats()
    try:
        with held_flash(torch, fa, ref, "wgmma", True) as checks:
            res = eng.generate(reqs)
    finally:
        model.prefill, model.decode = prefill, decode
    info["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    windows = sorted({c[7] for c in checks})
    info.update(
        flash_checked_launches=len(checks),
        flash_wgmma_launches=sum(c[5] for c in checks),
        flash_failed=sum(not c[2] for c in checks),
        flash_max_abs_err=max((c[3] for c in checks), default=None),
        flash_over_tol_without_score_term=sum(c[4] for c in checks),
        flash_launches_by_window={w: sum(c[7] == w for c in checks)
                                  for w in windows},
        flash_shape=checks[0][:2] if checks else None,
        stream_forward_s_with_checks=seen["stream_s"],
        replay_s=seen["replay_s"], replay_s_per_step=seen["replay_s"] / plen,
        decode_ms_per_token=res[0].decode_s / (max_new - 1) * 1e3,
        tokens=[r.tokens.tolist() for r in res])
    routed = (info["flash_wgmma_launches"] == len(checks) == cfg.num_layers
              and windows == [0, cfg.window])
    ok1 = routed and info["flash_failed"] == 0

    # the stream forward's last position against the replay and the dense
    # windowed forward
    ls = seen["stream_logits"]
    toks = np.stack([r.prompt for r in reqs])
    ld = _dense_logits(torch, eng, toks)
    lx = _dense_logits(torch, eng, toks, eng.params.win[0][0].norm1)
    ok_r, replay = _greedy_vs(torch, ls, seen["replay_logits"])
    ok_d, dense = _greedy_vs(torch, ls, ld, lx)
    ok2 = ok_r and ok_d
    info["stream_vs"] = dict(replay=replay, dense=dense)

    # one decode step traced, re-decoding position plen on the cache
    cache, cur = seen["cache"], seen["cur"]
    info["decode_trace"] = _trace(torch, lambda: model.decode(
        eng.params, dataclasses.replace(cache, length=plen), cur), 1)
    del eng, seen, cache
    info["checks"] = dict(flash=ok1, stream_vs_replay_and_dense=ok2)
    return ok1 and ok2, info


# (m)'s and (n)'s prompts: whole 64-position mLSTM chunks for xlstm;
# (n)'s cut from 1,024 to 768 tokens for the time limit (PERF.md §4:
# its prefill replays the prompt one decode step a token)
XLSTM_PROMPTS = (2048, 2048, 1024, 1024)
ENCDEC_PROMPTS = (768, 768, 512, 512)
# the requests each path also runs alone (batched against per-request):
# the shorter bucket's two, for the time limit (PERF.md §4)
ALONE = (2, 3)
# a traced xlstm prefill's kernels by class
XLSTM_CLASSES = {"GEMM": BF16_PREFILL_CLASSES["GEMM"],
                 "elementwise": r"elementwise|Elementwise",
                 "reduce / scan": r"reduce|Reduce|scan|Scan"}


def drive_xlstm_path(args, dev):
    """Path (m): ``ServeEngine(xlstm-1.3b, max_len=2048 + 16,
    batch_size=2)`` at full width and depth (48 blocks: 6 groups of 7
    mLSTMs and 1 sLSTM, d_model 2048, 4 heads of hd 512, chunk 64, vocab
    50,304), bf16, random weights from ``--seed``, on prompts of
    ``XLSTM_PROMPTS`` tokens, 16 new each. No TPU kernel covers xlstm:
    its products are plain torch, the sLSTM's steps one captured CUDA
    graph replayed (``xlstm._scan_graphed``).

    Checks: ``_generation_runs`` (without a flash kernel; batched against
    per-request generation for the ``ALONE`` requests); layer 0's
    ``mlstm_parallel`` at chunks 64 and 16 against the ``mlstm_step``
    recurrence at full width over 256 positions
    (``tests/test_models.py``, ``tests/test_perf_variants.py``): in
    fp64 the outputs and C within 1e-9 of the largest magnitude (one
    function, three evaluation orders), and in fp32 each chunked form's
    root mean square error against the fp64 recurrence within 1e-3 of
    the exact outputs' (the reference's element-by-element rule, rtol =
    atol = 1e-3, holds at its reduced width but not here, where a few
    outputs divide by a near-zero denominator and reach ~1e4-1e5, so no
    fp32 form, the recurrence included, meets it against the exact
    result: the outputs over it are printed);
    the prefill's last logits against ``forward(mode="train",
    last_only=True)``, and one decode step after it against the forward
    over the prompt and that token (one 2,049-position chunk: the
    chunking is a partition of one sum), each by ``_greedy_vs`` with the
    forward's own spread under a 2^-12 change of the first norm scale.
    Prints the state's bytes, the sLSTM scans' share of a 2 x 2048
    prefill (host clock, synchronized around each scan) and a traced
    prefill of 2 x 256 by class. Returns (ok, info)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import xlstm
    from repro_torch.serve.engine import GenRequest, ServeEngine

    cfg = get_config("xlstm-1.3b")
    max_new, vocab = 16, cfg.vocab_size
    info = {"resident_gib_before": _resident_gib(torch, dev),
            "groups": xlstm.group_shape(cfg)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = ServeEngine(cfg, device=None if dev.type == "cuda" else dev,
                      max_len=max(XLSTM_PROMPTS) + max_new, batch_size=2,
                      seed=args.seed)
    _sync(torch, dev)
    info["init_s"] = time.time() - t0
    info["n_params"] = eng.model.n_params()
    info["weights_gib"] = sum(t.numel() * t.element_size() for t in
                              eng.params.parameters()) / 2 ** 30
    st = eng.model.init_cache(2, 0)
    info["state_mib_batch_2"] = sum(
        getattr(st, f).numel() * 4 for f in ("mc", "mn", "mm", "sc", "sn",
                                             "sm", "sh")) / 2 ** 20
    del st
    rng = np.random.default_rng(args.seed + 19)
    reqs = [GenRequest(rng.integers(0, vocab, n).astype(np.int32), max_new)
            for n in XLSTM_PROMPTS]
    ok13, runs, buckets = _generation_runs(torch, eng, reqs, None, None,
                                           None, False, ALONE)
    info.update(runs)

    # layer 0 at full width: chunked against the recurrence and chunk 64
    # against 16, in fp64 (the same function) and in fp32 (against fp64)
    p0 = eng.params.mlstm[0][0]
    x = torch.randn((2, 256, cfg.d_model), device=dev,
                    generator=torch.Generator(dev).manual_seed(args.seed))

    def forms(x):
        st = xlstm.mlstm_zero_state(2, cfg.num_heads, cfg.hd(), dev)
        ys = []
        for t in range(x.shape[1]):
            y, st = xlstm.mlstm_step(cfg, p0, x[:, t:t + 1], st)
            ys.append(y)
        y64, (c64, _, _) = xlstm.mlstm_parallel(cfg, p0, x)
        y16, (c16, _, _) = xlstm.mlstm_parallel(
            dataclasses.replace(cfg, mlstm_chunk=16), p0, x)
        return {"steps": (torch.cat(ys, 1), st[0]), "chunk64": (y64, c64),
                "chunk16": (y16, c16)}
    exact = forms(x.double())
    y_ex, c_ex = exact["steps"]
    top, rms = float(y_ex.abs().max()), float(y_ex.square().mean().sqrt())
    layer = dict(exact_max=top, exact_rms=rms)
    for name in ("chunk64", "chunk16"):
        y, c = exact[name]
        layer[f"fp64_{name}_vs_steps_max_rel"] = float(
            (y - y_ex).abs().max()) / top
        layer[f"fp64_{name}_vs_steps_c_max_rel"] = float(
            (c - c_ex).abs().max() / c_ex.abs().max())
    for name, (y, _) in forms(x).items():
        err = y.double() - y_ex
        layer[f"fp32_{name}_rms_rel"] = float(err.square().mean().sqrt()) \
            / rms
        layer[f"fp32_{name}_max_rel"] = float(err.abs().max()) / top
        # the reference test's rule, element by element, against the exact
        # result: the outputs over it
        layer[f"fp32_{name}_over_allclose_1e-3"] = int(
            (err.abs() > 1e-3 + 1e-3 * y_ex.abs()).sum())
    info["layer0"] = layer
    ok4 = all(v <= 1e-9 for k, v in layer.items() if k.startswith("fp64")) \
        and all(layer[f"fp32_{n}_rms_rel"] <= 1e-3
                for n in ("chunk64", "chunk16"))
    del x, exact, y_ex, c_ex

    # the prefill against the train-mode forward; one decode step after
    # it against the forward over prompt + token
    toks = np.stack([reqs[i].prompt for i in buckets[-1]])
    norm = eng.params.mlstm[0][0].norm
    lp, state = eng.model.prefill(eng.params, {"tokens": toks}, eng.max_len)
    ok_p, info["prefill_vs_forward"] = _greedy_vs(
        torch, lp[:, -1, :vocab].float(), _dense_logits(torch, eng, toks),
        _dense_logits(torch, eng, toks, norm))
    nxt = lp[:, -1, :vocab].argmax(-1)[:, None]
    ld, state = eng.model.decode(eng.params, state, nxt)
    longer = np.concatenate([toks, nxt.cpu().numpy()], 1)
    one_chunk = types.SimpleNamespace(cfg=cfg, params=eng.params,
                                      model=build_model(dataclasses.replace(
                                          cfg, mlstm_chunk=longer.shape[1]),
                                          device=eng.device))
    ok_d, info["decode_vs_forward"] = _greedy_vs(
        torch, ld[:, -1, :vocab].float(),
        _dense_logits(torch, one_chunk, longer),
        _dense_logits(torch, one_chunk, longer, norm))
    del state, lp, ld

    # the sLSTM scans' share of one prefill, then the prefill traced
    scan, spent = xlstm.slstm_scan, []

    def timed_scan(*a, **kw):
        _sync(torch, dev)
        t0 = time.time()
        out = scan(*a, **kw)
        _sync(torch, dev)
        spent.append(time.time() - t0)
        return out
    xlstm.slstm_scan = timed_scan
    try:
        _sync(torch, dev)
        t0 = time.time()
        eng.model.prefill(eng.params, {"tokens": toks}, eng.max_len)
        _sync(torch, dev)
        wall = time.time() - t0
    finally:
        xlstm.slstm_scan = scan
    info["slstm"] = dict(prefill_s_synchronized=wall,
                         scans=len(spent), scan_s=sum(spent),
                         share=sum(spent) / wall,
                         ms_per_step=sum(spent) / len(spent)
                         / toks.shape[1] * 1e3)
    # traced on the first 256 positions: a 2,048-token prefill is ~470,000
    # kernels, which the tracer takes most of a minute to parse
    info["prefill_trace"] = _trace(torch, lambda: eng.model.prefill(
        eng.params, {"tokens": toks[:, :256]}, eng.max_len), 1,
        XLSTM_CLASSES, cpu=False)
    del eng
    info["checks"] = dict(batched=ok13, layer0=ok4,
                          prefill_vs_forward=ok_p,
                          decode_vs_forward=ok_d)
    return ok13 and ok4 and ok_p and ok_d, info


def drive_encdec_path(args, dev, fa, ref):
    """Path (n): ``ServeEngine(seamless-m4t-medium, max_len=768 + 16,
    batch_size=2)`` at full width and depth (12 encoder + 12 decoder
    layers, d_model 1024, 16 heads of hd 64, d_ff 4096, vocab 256,206
    padded to 256,256, 4,096 frames), bf16, random weights from
    ``--seed``, on prompts of ``ENCDEC_PROMPTS`` tokens, 16 new each, fed
    zero frames as the reference's engine feeds them: the prefill is the
    stream forward (each decoder layer's self-attention through the
    wgmma flash kernel; the encoder and the cross-attention dense), the
    cross cache, and the prompt's replay through decode (one captured
    CUDA graph a step).

    Checks: ``_generation_runs`` (every stream-prefill flash launch held
    to its plain version, all on the wgmma route; batched against
    per-request generation for the ``ALONE`` requests); then ``Model``
    directly on Gaussian frames (2, 4096, 1024) from ``--seed`` and the
    two 768-token prompts: the cross cache against
    ``_enc_kv(encode(frames))`` layer by layer (the same products: bit for
    bit, else within 2^-8 of the largest); the stream forward's last logits
    against the replay's last decode step and against the dense forward
    (``mode="train"``) by ``_greedy_vs`` (with the dense forward's own
    spread under a 2^-12 change of the first decoder norm scale); the
    cross-attention reached: layer 0's cross term on the embedded prompt
    nonzero with Gaussian frames and exactly 0 with zero frames, and the
    last logits moved by the frames; ``EmbeddingServer``'s
    rows on zero frames all equal (all zero: no bias anywhere, the
    reference's behaviour). Prints the encoder's seconds at 4,096 frames,
    the replay's ms a step, decode ms a token, a traced prefill by class
    and a traced decode step. Returns (ok, info)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import encdec
    from repro_torch.serve.engine import (EmbeddingServer, GenRequest,
                                          ServeEngine)

    cfg = get_config("seamless-m4t-medium")
    max_new, vocab, f = 16, cfg.vocab_size, cfg.frontend_tokens
    info = {"resident_gib_before": _resident_gib(torch, dev)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = ServeEngine(cfg, device=None if dev.type == "cuda" else dev,
                      max_len=max(ENCDEC_PROMPTS) + max_new, batch_size=2,
                      seed=args.seed)
    _sync(torch, dev)
    info["init_s"] = time.time() - t0
    info["n_params"] = eng.model.n_params()
    info["weights_gib"] = sum(t.numel() * t.element_size() for t in
                              eng.params.parameters()) / 2 ** 30
    rng = np.random.default_rng(args.seed + 23)
    reqs = [GenRequest(rng.integers(0, vocab, n).astype(np.int32), max_new)
            for n in ENCDEC_PROMPTS]
    ok13, runs, buckets = _generation_runs(torch, eng, reqs, fa, ref,
                                           "wgmma", True, ALONE)
    info.update(runs)

    # Model directly, Gaussian frames
    model, params = eng.model, eng.params
    toks = np.stack([reqs[i].prompt for i in buckets[-1]])
    s = toks.shape[1]
    frames = torch.randn((2, f, cfg.d_model), device=dev,
                         generator=torch.Generator(dev).manual_seed(
                             args.seed + 29)).to(torch.bfloat16)
    _sync(torch, dev)
    t0 = time.time()
    enc = encdec.encode(cfg, params, frames)
    _sync(torch, dev)
    info["encode_s"] = time.time() - t0
    t0 = time.time()
    lg, cache = model.prefill(params, {"tokens": toks, "frames": frames},
                              s + max_new)
    _sync(torch, dev)
    info["prefill_s_gaussian"] = time.time() - t0
    x0 = params.embed.tok[torch.as_tensor(toks, device=dev)].to(
        torch.bfloat16)

    def cross0(c):
        """Layer 0's cross-attention term on the embedded prompt."""
        return (encdec._cross(cfg, params.dec[0], x0, (c.xk[0], c.xv[0]))
                - x0).float().abs().max()
    cross_gauss = float(cross0(cache))
    worst, equal = 0.0, True
    for i, bp in enumerate(params.dec):
        ek, ev = encdec._enc_kv(cfg, bp, enc)
        for got, want in ((cache.xk[i], ek), (cache.xv[i], ev)):
            equal &= bool(torch.equal(got, want))
            worst = max(worst, float((got.float() - want.float()).abs()
                                     .max() / want.float().abs().max()))
    ok_x = worst <= 2.0 ** -8
    info["cross_cache"] = dict(bit_equal=equal, max_rel_err=worst)
    del enc
    t0 = time.time()
    for t in range(s):
        lr, cache = model.decode(params, cache, toks[:, t:t + 1])
    _sync(torch, dev)
    info["replay_ms_per_step"] = (time.time() - t0) / s * 1e3
    cur = lr[:, -1, :vocab].argmax(-1)[:, None]
    t0 = time.time()
    for _ in range(max_new - 1):
        ln, cache = model.decode(params, cache, cur)
        cur = ln[:, -1, :vocab].argmax(-1)[:, None]
    _sync(torch, dev)
    info["decode_ms_per_token_gaussian"] = (time.time() - t0) \
        / (max_new - 1) * 1e3
    # one decode step traced (the graph replayed at the last position)
    info["decode_trace"] = _trace(torch, lambda: model.decode(
        params, dataclasses.replace(cache, length=s + max_new - 1), cur),
        1, cpu=False)
    del cache
    ls = lg[:, -1, :vocab].float()
    ok_r, replay = _greedy_vs(torch, ls, lr[:, -1, :vocab].float())
    ok_d, dense_vs = _greedy_vs(
        torch, ls, _dense_logits(torch, eng, toks, frames=frames),
        _dense_logits(torch, eng, toks, params.dec[0].norm1, frames=frames))
    zero = torch.zeros_like(frames)
    lz, zcache = model.prefill(params, {"tokens": toks, "frames": zero},
                               s + max_new)
    moved = float((lz[:, -1, :vocab].float() - ls).abs().max())
    cross_zero = float(cross0(zcache))
    ok_z = cross_gauss > 0 and cross_zero == 0 and moved > 0
    info["stream_vs"] = dict(replay=replay, dense=dense_vs)
    info["cross_attention"] = dict(
        layer0_term_max_gaussian=cross_gauss, layer0_term_max_zero=cross_zero,
        zero_vs_gaussian_frames_max_logit_diff=moved)
    del lz, zcache, lr, ln, x0

    emb = EmbeddingServer(cfg, params, device=None if dev.type == "cuda"
                          else dev).embed(toks[:, :128])
    ok_e = bool((emb == emb[:1]).all())
    info["embedding_rows"] = dict(shape=list(emb.shape), all_equal=ok_e,
                                  max_abs=float(np.abs(emb).max()))
    info["prefill_trace"] = _trace(torch, lambda: model.prefill(
        params, {"tokens": toks, "frames": frames}, s + max_new), 1,
        BF16_PREFILL_CLASSES)
    del eng, model, params, frames, zero
    info["checks"] = dict(flash_and_batched=ok13, cross_cache=ok_x,
                          stream_vs_replay_and_dense=ok_r and ok_d,
                          cross_attention_reached=ok_z,
                          zero_frame_embeddings_equal=ok_e)
    return all(info["checks"].values()), info


# ----------------------------------------------------------- (p) training
TRAIN_ARCH = "mqrld-embedder-100m"
TRAIN_SEQ = 512          # train()'s default seq_len
TRAIN_MB = 2             # microbatches: a global batch of 8 x 2 rows
# 20 steps, a checkpoint every 10, a resume to 24: cut to 12 / 6 / 14 for
# the time limit, the last 5 steps' mean loss was not below the first's
# (10.9172 against 10.9164), so that cut is not taken (PERF.md §4)
TRAIN_STEPS = 20
TRAIN_EVERY = 10         # checkpoint_every: the step-10 checkpoint
TRAIN_RESUME = 24        # the second train()'s total_steps
TRAIN_INT8_STEPS = 3      # cut from 5 for the time limit (PERF.md §4)
TRAIN_LR, TRAIN_WARMUP = 3e-4, 2
TRAIN_DOCS = (2000, 64)  # examples/train_embedder.py's documents
TRAIN_QUERIES = 64
# The fp32 step against fp64's. At the reference's init law the q and k
# projections draw with the head count as fan-in (``shape[-2]``), so the
# q.k scores run to the hundreds and attention is one-hot: a move of the
# masters by one fp32 rounding (PERTURB, random signs) moves fp64's own
# gradient by over 100% of its RMS at full width (whole percents at 4
# layers on the CPU). There the step's loss is held (the bf16 loss within
# BF16_LOSS_RTOL of fp64's) and each fp32 gradient leaf within FP64_COND
# times that move. The gradient itself is held at the same step from the
# masters with q and k scaled to the d_model fan-in (``_tempered``),
# where the scores are O(1): each fp32 leaf's RMS error within
# FP64_GRAD_RTOL of the leaf's RMS (1e-6 measured on the CPU at 8 layers
# of 512).
FP64_GRAD_RTOL = 1e-3
FP64_COND = 64.0
BF16_LOSS_RTOL = 2.0 ** -7
PERTURB = 2.0 ** -24
LAW_ROWS = 256           # rows of each embedding table in the AdamW law
# a train step's kernels by class, for its trace (first match wins)
TRAIN_CLASSES = {"GEMM": r"gemm|Gemm|GEMM|cutlass|nvjet|xmma|matmul",
                 "softmax": r"softmax|logsumexp",
                 "index (embedding, CE)": r"index|scatter|gather",
                 "reduce": r"reduce"}


def _rms(x) -> float:
    return float(x.double().pow(2).mean().sqrt())


def max_ulps(torch, a, b) -> int:
    """The largest distance between two fp32 tensors in units in the last
    place (0: bit for bit); between int8 codes, in codes."""
    if a.dtype == torch.int8:
        return int((a.int() - b.int()).abs().max()) if a.numel() else 0
    ia, ib = (t.contiguous().view(torch.int32).long() for t in (a, b))
    # sign-magnitude bits to one monotone integer line (-0 meets +0)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max()) if a.numel() else 0


def _tempered(cfg, masters):
    """The masters with the q and k projections scaled by
    sqrt(hp / d_model): drawn at the fan-in of d_model instead of the
    head count, which puts the attention scores at O(1)."""
    f = math.sqrt(cfg.hp() / cfg.d_model)
    return {k: t * f if k in ("blocks/attn/wq", "blocks/attn/wk") else t
            for k, t in masters.items()}


def _leaf_errors(runs, keys):
    """{leaf: RMS errors over fp64's leaf RMS} of each run but fp64."""
    g64 = runs["fp64"][1]
    out = {}
    for k in keys:
        r = _rms(g64[k])
        out[k] = {"rms": r, **{n: _rms(g[k].double() - g64[k]) / r
                               for n, (_, g) in runs.items()
                               if n != "fp64"}}
    return out


def check_train_numerics(args, dev, cfg):
    """Before the loop, on step 0's batch (``8 * TRAIN_MB`` rows of
    ``TRAIN_SEQ`` tokens, two microbatches): the step's loss and gradient
    (``loss_and_grads``) from the masters ``train()`` starts from, in
    fp64, in fp64 from masters moved by ``PERTURB``, in fp32 and in bf16;
    and from those masters ``_tempered``, in fp64 and fp32. Holds the
    bf16 loss to fp64's (``BF16_LOSS_RTOL``), every fp32 leaf at the init
    law within ``FP64_COND`` times the moved gradient's distance, and
    every tempered fp32 leaf within ``FP64_GRAD_RTOL`` of its RMS (the
    block comment above says why). Then the AdamW law: two updates on the
    card (fp32 state; the fp32 step's gradient, then the bf16 step's) and
    one in int8 state, each against the same update on the CPU from
    copies of the same masters, state and gradients, with the card's
    global norm: new masters and every state array bit for bit; the norms
    themselves within 1e-6 relative (sums of squares in another order).
    Returns (error or None, info)."""
    import dataclasses

    import torch
    from repro_torch.configs import TrainConfig
    from repro_torch.data.pipeline import PipelineSpec, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as O
    from repro_torch.train.step import loss_and_grads

    batch = SyntheticLM(PipelineSpec(cfg.vocab_size, TRAIN_SEQ,
                                     8 * TRAIN_MB, seed=args.seed)).batch(0)
    masters = build_model(cfg, device=dev).init_masters(args.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 7)
    moved = {k: t.double() * (1 + PERTURB * (2 * torch.randint(
        0, 2, t.shape, generator=gen, device=dev) - 1)) for k, t in
        masters.items()}
    tempered = _tempered(cfg, masters)
    runs, temp, secs = {}, {}, {}
    for name, dt, ps, out in (("fp64", "float64", masters, runs),
                              ("fp64 moved", "float64", moved, runs),
                              ("fp32", "float32", masters, runs),
                              ("bf16", "bfloat16", masters, runs),
                              ("fp64", "float64", tempered, temp),
                              ("fp32", "float32", tempered, temp)):
        m = build_model(dataclasses.replace(cfg, dtype=dt), device=dev)
        t0 = time.time()
        loss, grads = loss_and_grads(m, ps, batch, TRAIN_MB)
        _sync(torch, dev)
        secs[name + (" tempered" if out is temp else "")] = time.time() - t0
        out[name] = (float(loss), grads)
    del moved, tempered
    leaves = _leaf_errors(runs, masters)
    t_leaves = _leaf_errors(temp, masters)
    l64 = runs["fp64"][0]
    rel = {n: abs(runs[n][0] - l64) / abs(l64) for n in ("fp32", "bf16")}
    info = dict(seconds=secs, loss_fp64=l64, loss_rel_err=rel,
                leaves=leaves, tempered_leaves=t_leaves,
                tempered_loss_rel_err=abs(temp["fp32"][0] - temp["fp64"][0])
                / abs(temp["fp64"][0]),
                worst_fp32=max(v["fp32"] for v in leaves.values()),
                worst_fp32_over_moved=max(
                    v["fp32"] / max(v["fp64 moved"], 1e-300)
                    for v in leaves.values()),
                worst_tempered_fp32=max(v["fp32"]
                                        for v in t_leaves.values()))
    g1 = runs["fp32"][1]
    g2 = {k: g.float() for k, g in runs["bf16"][1].items()}
    del runs, temp
    bad = [k for k, v in leaves.items()
           if not v["fp32"] <= FP64_COND * v["fp64 moved"]]
    bad += [f"{k} (tempered)" for k, v in t_leaves.items()
            if not v["fp32"] <= FP64_GRAD_RTOL]
    if bad:
        return (f"train numerics: the fp32 gradient of {bad} is further "
                f"from fp64's than the rules allow"), info
    if not rel["bf16"] <= BF16_LOSS_RTOL:
        return (f"train numerics: the bf16 loss lies {rel['bf16']:.3g} "
                f"from fp64's (rule {BF16_LOSS_RTOL})"), info

    tc = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                     total_steps=TRAIN_STEPS)
    cpu = torch.device("cpu")
    law = {}
    for sd, gs in (("float32", (g1, g2)), ("int8", (g1,))):
        card = (masters, O.init_adam(masters, sd))
        part = {k: _law_part(k, t).to(cpu) for k, t in masters.items()}
        host = (part, O.init_adam(part, sd))
        ulps, norms = {}, []
        t_card = 0.0
        for g in gs:
            t0 = time.time()
            p, s, n = O.adam_update(tc, card[0], g, card[1], sd)
            _sync(torch, dev)
            t_card += time.time() - t0
            n_host = O.global_norm({k: t.to(cpu) for k, t in g.items()})
            hp, hs, _ = O.adam_update(
                tc, host[0], {k: _law_part(k, t).to(cpu)
                              for k, t in g.items()},
                host[1], sd, gnorm=n.to(cpu))
            norms.append(abs(float(n) - float(n_host)) / float(n_host))
            card, host = (p, s), (hp, hs)
        for k, t in card[0].items():
            ulps[f"params/{k}"] = max_ulps(
                torch, _law_part(k, t).cpu(), host[0][k])
        for name in ("m", "v"):
            for k, enc in getattr(card[1], name).items():
                want = getattr(host[1], name)[k]
                pairs = zip(enc, want) if isinstance(enc, tuple) else \
                    [(enc, want)]
                for j, (a, b) in enumerate(pairs):
                    ulps[f"{name}/{k}/{j}"] = max_ulps(
                        torch, _law_part(k, a).cpu(), b)
        worst = max(ulps.values())
        law[sd] = dict(updates=len(gs), max_ulps=worst,
                       arrays=len(ulps), norm_rel_diff=norms,
                       elements_held=sum(t.numel() for t in part.values()),
                       card_update_s=t_card / len(gs),
                       int8_moments=sum(isinstance(e, tuple)
                                        for e in card[1].m.values()))
        if worst or max(norms) > 1e-6:
            info["adamw"] = law
            bad = sorted(k for k, u in ulps.items() if u)[:5]
            return (f"AdamW ({sd} state) on the card differs from the CPU: "
                    f"{worst} ulps ({bad}), norms {norms}"), info
    info["adamw"] = law
    return None, info


def _law_part(key: str, t):
    """The part of a leaf whose update the CPU repeats: a stacked
    block leaf's first layer, an embedding table's first ``LAW_ROWS``
    rows, a vector whole. Each element's update reads only its own
    entries and its last-axis channel's int8 scale, so a leading slice
    of the whole update is the update of the slice."""
    if t.dim() < 2:
        return t
    return t[:1] if key.startswith("blocks/") else t[:LAW_ROWS]


def _doc_queries(Q, np, emb, lengths, radius: float, n: int, seed: int):
    """``n`` hybrid queries over the documents' embeddings, the example's
    ``And(NR, VK k=10)`` first, then the four archetypes in turn."""
    rng = np.random.default_rng(seed)
    out = [Q.And.of(Q.NR("length", 100, 400), Q.VK.of("text", emb[0], 10))]
    for j, i in enumerate(rng.integers(0, len(emb), n - 1)):
        v = emb[i]
        out.append([
            Q.VK.of("text", v, 10),
            Q.And.of(Q.NR("length", 100, 400), Q.VK.of("text", v, 10)),
            Q.And.of(Q.VR.of("text", v, radius), Q.NR("length", 50, 300)),
            Q.And.of(Q.VR.of("text", v, radius), Q.VK.of("text", v, 10)),
        ][j % 4])
    return out


def drive_train_path(args, dev):
    """Path (p): ``mqrld-embedder-100m`` trained at full size (12 layers,
    768 wide, 12 heads padded to 16, vocab 32,768; bf16 compute, fp32
    masters, ``remat="block"``) through the port's ``train()``:
    ``check_train_numerics`` first; then ``TRAIN_STEPS`` steps of
    ``8 * TRAIN_MB`` x ``TRAIN_SEQ`` SyntheticLM tokens with a checkpoint
    every ``TRAIN_EVERY``: the mean loss of the last 5 steps below the
    first step's; the step-``TRAIN_EVERY`` checkpoint restored with every
    hash checked and equal, array for array, to the state handed to
    ``save`` (captured on the card); a second
    ``train(total_steps=TRAIN_RESUME)`` restoring step ``TRAIN_STEPS``
    and running the rest; ``TRAIN_INT8_STEPS`` steps in int8 state
    (finite, m and v int8 codes with (..., 1) scales). Then the trained
    masters feed the platform as ``examples/train_embedder.py`` does:
    ``EmbeddingServer`` embeds its 2,000 x 64 documents (two topical
    groups), ``MQRLD(...).prepare(min_leaf=16, max_leaf=256)`` builds
    over them, and the example's query plus 63 hybrid queries run through
    ``session().plan().execute()``, every row the oracle's. Returns
    (error or None, info)."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.core import query as Q
    from repro_torch.core.lake import MMOTable
    from repro_torch.core.platform import MQRLD
    from repro_torch.data.pipeline import PipelineSpec, SyntheticLM
    from repro_torch.models import build_model, params_from_masters
    from repro_torch.serve.engine import EmbeddingServer
    from repro_torch.train import loop
    from repro_torch.utils.roofline import model_flops_for, peak_flops

    cfg = get_config(TRAIN_ARCH)
    on = None if dev.type == "cuda" else dev
    info = dict(n_params=build_model(cfg, device=dev).n_params(),
                resident_gib_before=_resident_gib(torch, dev))
    t0 = time.time()
    err, info["numerics"] = check_train_numerics(args, dev, cfg)
    info["numerics_s"] = time.time() - t0
    if err:
        return err, info
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="train_path_")
    lines = []
    try:
        tc = TrainConfig(total_steps=TRAIN_STEPS, learning_rate=TRAIN_LR,
                         warmup_steps=TRAIN_WARMUP, microbatches=TRAIN_MB,
                         checkpoint_every=TRAIN_EVERY, seed=args.seed,
                         checkpoint_dir=os.path.join(root, "run"))
        saved = {}
        real_save = loop.Checkpointer.save

        def save(self, step, tree, extra=None, block=False):
            if step == TRAIN_EVERY:
                saved.update({k: v.clone() for k, v in
                              C._flatten(tree).items()})
            return real_save(self, step, tree, extra, block)
        loop.Checkpointer.save = save
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        try:
            res = loop.train(cfg, tc, seq_len=TRAIN_SEQ, log_every=5,
                             log_fn=lines.append, device=on)
        finally:
            loop.Checkpointer.save = real_save
        info["train_s"] = time.time() - t0
        info["peak_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                            if dev.type == "cuda" else 0.0)
        step_s = float(np.median(res.step_s[1:]))
        shape = ShapeConfig("train_path", TRAIN_SEQ, 8 * TRAIN_MB, "train")
        info.update(
            steps=res.steps_run, first_step_s=res.step_s[0],
            step_s=step_s, step_s_all=res.step_s,
            tokens_per_s=TRAIN_SEQ * 8 * TRAIN_MB / step_s,
            model_flops=model_flops_for(cfg, shape),
            mfu=model_flops_for(cfg, shape) / step_s / peak_flops("bf16"),
            loss_first=res.losses[0], loss_last=res.losses[-1],
            loss_last5_mean=float(np.mean(res.losses[-5:])),
            losses=res.losses, skipped=res.skipped_steps, log=lines)
        if res.steps_run != TRAIN_STEPS or res.skipped_steps:
            return f"train: {res.steps_run} steps, {res.skipped_steps} " \
                   f"skipped", info
        if not info["loss_last5_mean"] < res.losses[0]:
            return (f"train: the last 5 steps' mean loss "
                    f"{info['loss_last5_mean']:.4f} is not below the "
                    f"first's {res.losses[0]:.4f}"), info
        if dev.type == "cuda":
            # one more step from the trained state, traced: where a
            # step's device time goes, and how busy the card is
            step = loop.make_train_step(build_model(cfg, device=dev), tc)
            batch = SyntheticLM(PipelineSpec(
                cfg.vocab_size, TRAIN_SEQ, 8 * TRAIN_MB,
                seed=args.seed)).batch(TRAIN_STEPS)
            info["step_trace"] = _trace(
                torch, lambda: step(res.params, res.opt, batch), 1,
                TRAIN_CLASSES, cpu=False)
            del step

        # the step-TRAIN_EVERY checkpoint, hashes verified, equal to what
        # was saved
        ck = C.Checkpointer(tc.checkpoint_dir)
        info["checkpoints"] = ck.all_steps()
        t0 = time.time()
        back, extra = ck.restore(TRAIN_EVERY, (res.params, res.opt))
        info["restore_s"] = time.time() - t0
        got = C._flatten(back)
        info["restored_arrays"] = len(got)
        diff = [k for k in saved if not torch.equal(got[k], saved[k])]
        if sorted(got) != sorted(saved) or diff or \
                extra.get("step") != TRAIN_EVERY or \
                int(back[1].count) != TRAIN_EVERY:
            return (f"checkpoint {TRAIN_EVERY}: restored state differs from "
                    f"the saved one in {diff[:5]} (of {len(saved)}), extra "
                    f"{extra}"), info
        info["checkpoint_gib"] = sum(
            os.path.getsize(os.path.join(tc.checkpoint_dir,
                                         f"step_{TRAIN_EVERY}", f))
            for f in os.listdir(os.path.join(
                tc.checkpoint_dir, f"step_{TRAIN_EVERY}"))) / 2 ** 30
        del back, got, saved
        t0 = time.time()
        res2 = loop.train(cfg, dataclasses.replace(
            tc, total_steps=TRAIN_RESUME), seq_len=TRAIN_SEQ, log_every=5,
            log_fn=lines.append, device=on)
        info["resume_s"] = time.time() - t0
        info["resume"] = dict(restored_from=res2.restored_from,
                              steps=res2.steps_run, losses=res2.losses)
        if res2.restored_from != TRAIN_STEPS or \
                res2.steps_run != TRAIN_RESUME - TRAIN_STEPS or \
                not np.isfinite(res2.losses).all():
            return f"resume: {info['resume']}", info
        del res

        # int8 state
        t0 = time.time()
        res3 = loop.train(cfg, dataclasses.replace(
            tc, total_steps=TRAIN_INT8_STEPS, checkpoint_every=0,
            checkpoint_dir=os.path.join(root, "int8")), seq_len=TRAIN_SEQ,
            state_dtype="int8", log_every=5, log_fn=lines.append,
            device=on)
        info["int8_s"] = time.time() - t0
        coded = [isinstance(res3.opt.m[k], tuple) and
                 isinstance(res3.opt.v[k], tuple) and
                 res3.opt.m[k][0].dtype == torch.int8 and
                 res3.opt.v[k][0].dtype == torch.int8 and
                 tuple(res3.opt.m[k][1].shape) == p.shape[:-1] + (1,)
                 for k, p in res3.params.items() if p.dim() >= 2]
        finite = bool(np.isfinite(res3.losses).all()) and all(
            bool(torch.isfinite(p).all()) for p in res3.params.values())
        info["int8"] = dict(steps=res3.steps_run, losses=res3.losses,
                            coded_leaves=sum(coded), finite=finite)
        if res3.steps_run != TRAIN_INT8_STEPS or not finite or \
                not all(coded) or not coded:
            return f"int8 state: {info['int8']}", info
        del res3
        gc.collect()

        # the trained embedder feeds the platform
        t0 = time.time()
        srv = EmbeddingServer(cfg, params_from_masters(cfg, res2.params),
                              device=on)
        rng = np.random.default_rng(0)
        docs = rng.integers(1, cfg.vocab_size // 2, TRAIN_DOCS).astype(
            np.int32)
        half = TRAIN_DOCS[0] // 2
        docs[half:] += cfg.vocab_size // 3   # two topical groups
        emb = srv.embed(docs)
        info["embed_s"] = time.time() - t0
        del srv, res2
        if emb.shape != (TRAIN_DOCS[0], cfg.d_model) or \
                not np.isfinite(emb).all():
            return f"embeddings: shape {emb.shape}, not all finite", info
        lengths = rng.uniform(50, 500, len(docs)).astype(np.float32)
        table = (MMOTable("docs").add_vector("text", emb, model=cfg.name)
                 .add_numeric("length", lengths))
        t0 = time.time()
        p = MQRLD(table, seed=0, device=on)
        p.prepare(min_leaf=16, max_leaf=256)
        _sync(torch, dev)
        info["prepare_s"] = time.time() - t0
        d = np.sqrt(((emb[:64, None] - emb[None]) ** 2).sum(-1))
        radius = float(f"{float(np.median(np.sort(d, 1)[:, 10])):.4g}")
        batch = _doc_queries(Q, np, emb, lengths, radius, TRAIN_QUERIES,
                             args.seed + 9)
        t0 = time.time()
        res_rows, stats = p.session().plan(batch).execute()
        _sync(torch, dev)
        info["batch_s"] = time.time() - t0
        bad, truths = oracle_mismatches(p, batch, res_rows)
        vk = [i for i, q in enumerate(batch) if isinstance(q, Q.VK)]
        info["platform"] = dict(
            radius=radius, queries=len(batch), mismatches=len(bad),
            rows_min=min(map(len, res_rows)),
            rows_max=max(map(len, res_rows)),
            example_rows=len(res_rows[0]),
            same_group_share=float(np.mean([
                np.mean((res_rows[i] >= half) == (int(
                    np.argmin(((emb - batch[i].vec()) ** 2).sum(-1)))
                    >= half)) for i in vk])))
        if bad:
            i = bad[0]
            return (f"platform over the trained embeddings: query {i} "
                    f"differs from the oracle: got {res_rows[i][:10]} want "
                    f"{truths[i][:10]}"), info
        if len(res_rows[0]) == 0:
            return "platform: the example's query returned no row", info
        del p
        return None, info
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ------------------------------------------------ (q) the families trained
# (name, depth, seq, rows, microbatches). xlstm-1.3b whole (48 blocks,
# 6 of them sLSTM); hymba-1.5b one group of its four, 8 of 32 layers (7
# windowed + 1 global), at a sequence past its 1,024-token window;
# seamless-m4t-medium 2 + 2 of its 12 + 12 layers on its 4,096 frames,
# 8 rows in 2 microbatches of 4 (the encoder's fp32 scores are 1 GiB a
# row a layer). hymba's sequence 1536 -> 1152 and seamless's 4 + 4
# layers -> 2 + 2 are cuts for the time limit (PERF.md §4).
FAMILY_RUNS = (("xlstm-1.3b", {}, 512, 16, 2),
               ("hymba-1.5b", {"num_layers": 8}, 1152, 8, 2),
               ("seamless-m4t-medium", {"num_layers": 2, "enc_layers": 2},
                512, 8, 2))
FAMILY_STEPS = 3        # make_train_step steps, all on the first batch
FAMILY_LR, FAMILY_WARMUP = 1e-3, 1
# At the init law xlstm-1.3b's gradient norm overflows fp32 (the mLSTM
# divides by near-zero denominators, and the gain compounds over the
# blocks: 1.1e7 at 8 layers, 1.5e12 at 16 on the CPU, inf at 48 on the
# card, where the clip then zeroes every step and the third is NaN; the
# reference sums the same squares in fp32), and seamless-m4t-medium's
# loss rose over its first three steps on the card (12.9629, 12.9823,
# 12.9781; gradient norm 2.1e7: attention one-hot). Their steps start
# from the masters with q and k tempered (xlstm: 1.4e3 at 16 layers);
# hymba trains from its init masters.
FAMILY_TEMPERED_STEPS = ("xlstm-1.3b", "seamless-m4t-medium")
# AdamW's state type by family: xlstm-1.3b's in int8, which halves its
# checkpoint (13.85 GiB in fp32 state: 42.7 s to save, 52.7 s to
# restore on the card, over the path's time)
FAMILY_STATE = {"xlstm-1.3b": "int8"}
# the fp32 gradient against fp64's, on the batch's first 2 rows, at the
# depth of one group of each family at full width: xlstm 1 mLSTM + 1
# sLSTM, hymba 1 windowed + 1 global block, enc-dec 1 + 1 layers
FAMILY_GRAD_DEPTH = {"xlstm-1.3b": dict(num_layers=2, slstm_every=2),
                     "hymba-1.5b": dict(num_layers=2, global_every=2),
                     "seamless-m4t-medium": dict(num_layers=1,
                                                 enc_layers=1)}
FAMILY_GRAD_ROWS = 2
# SLSTMScan graphed against the same Function run step by step on the
# card: outputs and gradients within SLSTM_TOL of each tensor's largest
# magnitude (the same kernels in the same order: bit for bit expected)
SLSTM_TOL = 1e-6
# the compressed cross-pod step: the embedder at full size over
# COMPRESS_PODS pods, held to one plain step on the same batch by the
# reference's own bounds (tests/test_system.py), then COMPRESS_STEPS more
COMPRESS_PODS = 2
COMPRESS_STEPS = 3
COMPRESS_LOSS_TOL, COMPRESS_PARAM_TOL = 0.05, 1e-2


def _tempered_qk(masters):
    """The masters with every q and k projection (the leaves named
    ``wq`` and ``wk``, (..., d_model, heads, hd): attention's, the
    cross-attention's and the mLSTM's) scaled by sqrt(heads / d_model),
    as ``_tempered`` does for the transformer: drawn at the fan-in of
    d_model instead of the head count."""
    return {k: t * math.sqrt(t.shape[-2] / t.shape[-3])
            if k.rsplit("/", 1)[-1] in ("wq", "wk") else t
            for k, t in masters.items()}


def _family_batch(cfg, model, seq: int, rows: int, seed: int):
    """xlstm and hymba: ``train()``'s data, SyntheticLM's step-0 batch;
    enc-dec: ``Model.make_batch`` (Gaussian frames, random tokens)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.data.pipeline import PipelineSpec, SyntheticLM
    if cfg.is_encdec:
        return model.make_batch(ShapeConfig("q", seq, rows, "train"), seed)
    return SyntheticLM(PipelineSpec(cfg.vocab_size, seq, rows,
                                    seed=seed)).batch(0)


def _mean_loss(torch, model, masters, batch, pieces: int) -> float:
    """The step's loss without its gradient: the masters cast to the
    model's type, ``Model.loss`` averaged over ``pieces`` equal row
    blocks (the microbatches' mean)."""
    from repro_torch.models.transformer import torch_dtype
    from repro_torch.train.step import split_microbatches
    dt = torch_dtype(model.cfg.dtype)
    p_c = {k: t.to(dt) for k, t in masters.items()}
    with torch.no_grad():
        parts = [float(model.loss(p_c, mb)) for mb in split_microbatches(
            {k: torch.as_tensor(v, device=model.device)
             for k, v in batch.items()}, pieces)]
    return sum(parts) / pieces


def check_slstm_function(torch, dev, cfg, masters, rows: int, seq: int,
                         seed: int):
    """``SLSTMScan`` at the path's shape (one microbatch) on xlstm's first
    sLSTM block at the init masters, on a Gaussian input: forward and
    backward (a random cotangent on the outputs and on the final c)
    graphed, then the same Function run step by step on the card.
    Returns (ok, info): each output and gradient's largest difference
    over its largest magnitude, held to ``SLSTM_TOL``, and the seconds
    of each."""
    from repro_torch.models import xlstm
    h, hd, d = cfg.num_heads, cfg.hd(), cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(seed + 11)
    x = torch.randn((rows, seq, d), generator=gen, device=dev)
    wx = (x @ masters["slstm/wx"][0].reshape(d, 4 * h * hd)).view(
        rows, seq, 4, h, hd) + masters["slstm/b"][0]
    r = masters["slstm/r"][0].transpose(0, 1).reshape(h, 4 * hd, hd)
    dys = torch.randn((rows, seq, h, hd), generator=gen, device=dev)
    dc = torch.randn((rows, h, hd), generator=gen, device=dev)
    runs, secs = {}, {}
    for graphed in (dev.type == "cuda", False):
        ri = r.clone().requires_grad_(True)
        wi = wx.clone().requires_grad_(True)
        st = xlstm.slstm_zero_state(rows, h, hd, dev)
        _sync(torch, dev)
        t0 = time.time()
        ys, c, n, m, hl = xlstm.SLSTMScan.apply(ri, wi, *st, graphed)
        _sync(torch, dev)
        t1 = time.time()
        dr, dwx = torch.autograd.grad((ys * dys).sum() + (c * dc).sum(),
                                      (ri, wi))
        _sync(torch, dev)
        name = "graphed" if not runs else "step by step"
        secs[name] = dict(forward_s=t1 - t0, backward_s=time.time() - t1)
        runs[name] = {k: t.detach() for k, t in dict(
            ys=ys, c=c, n=n, m=m, h=hl, dr=dr, dwx=dwx).items()}
    diff = {k: float((runs["graphed"][k] - b).abs().max())
            / max(float(b.abs().max()), 1e-30)
            for k, b in runs["step by step"].items()}
    ok = all(v <= SLSTM_TOL for v in diff.values())
    return ok, dict(shape=[rows, seq, h, hd], max_rel_diff=diff,
                    tolerance=SLSTM_TOL, seconds=secs,
                    bit_for_bit=all(v == 0 for v in diff.values()))


def hymba_scan_saved(torch, dev, cfg, params, rows: int, seq: int,
                     seed: int):
    """What autograd keeps for the backward of one global hymba block's
    Mamba branch (``mamba_scan``) on a microbatch of the path's shape,
    and the share the Hillis-Steele scan (``hymba._scan_chunks``) holds:
    its ``torch.cat`` at each shift saves every level. Bytes of distinct
    storages, as saved-tensor hooks see them."""
    from repro_torch.models import hymba
    from repro_torch.models.transformer import torch_dtype
    dt = torch_dtype(cfg.dtype)
    views = hymba.stacked_views(cfg, {k: t.to(dt).requires_grad_(True)
                                      for k, t in params.items()})
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    x = torch.randn((rows, seq, cfg.d_model), generator=gen,
                    device=dev).to(dt).requires_grad_(True)
    seen, scan_seen, inside = {}, {}, [False]

    def pack(t):
        st = t.untyped_storage()
        (scan_seen if inside[0] else seen)[st.data_ptr()] = st.nbytes()
        return t
    real = hymba._scan_chunks

    def scan(*a):
        inside[0] = True
        try:
            return real(*a)
        finally:
            inside[0] = False
    hymba._scan_chunks = scan
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out, _ = hymba.mamba_scan(cfg, views.glob[0].mamba, x)
    finally:
        hymba._scan_chunks = real
    del out, views
    scan_b = sum(scan_seen.values())
    other = sum(v for k, v in seen.items() if k not in scan_seen)
    return dict(rows=rows, seq=seq, saved_gib=(scan_b + other) / 2 ** 30,
                scan_levels_gib=scan_b / 2 ** 30,
                scan_storages=len(scan_seen))


def drive_family_train(args, dev, name: str, depth: dict, seq: int,
                       rows: int, mb: int):
    """One family of path (q): ``name`` at full width and ``depth``
    (bf16 compute, fp32 masters, the config's block remat), on ``rows``
    x ``seq`` tokens in ``mb`` microbatches. Checks, in order: the bf16
    loss at the init masters within ``BF16_LOSS_RTOL`` of fp64's on the
    same masters and batch; every fp32 gradient leaf within
    ``FP64_GRAD_RTOL`` (RMS over the leaf's RMS) of fp64's at the depth
    of ``FAMILY_GRAD_DEPTH`` on ``FAMILY_GRAD_ROWS`` rows, from the
    masters with q and k tempered (``_tempered_qk``); xlstm only,
    ``check_slstm_function``; ``FAMILY_STEPS`` steps of
    ``make_train_step`` on the batch (from tempered masters for
    ``FAMILY_TEMPERED_STEPS``; AdamW's state in ``FAMILY_STATE``'s type),
    finite, the last loss below the first; xlstm only, one checkpoint of (masters, AdamW state) saved
    and restored equal, array for array. Returns (error or None,
    info): step seconds (first and median of the rest), tokens/s, MFU
    (``model_flops_for`` over the bf16 peak), peak GiB."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.configs import ShapeConfig, TrainConfig, get_config
    from repro_torch.models import build_model
    from repro_torch.train import optimizer as O
    from repro_torch.train.step import loss_and_grads, make_train_step
    from repro_torch.utils.roofline import model_flops_for, peak_flops

    cfg = dataclasses.replace(get_config(name), **depth)
    info = dict(layers=cfg.num_layers, enc_layers=cfg.enc_layers,
                seq=seq, rows=rows, microbatches=mb,
                resident_gib_before=_resident_gib(torch, dev))
    t0 = time.time()
    model = build_model(cfg, device=dev)
    info["n_params"] = model.n_params()
    masters = model.init_masters(args.seed)
    batch = _family_batch(cfg, model, seq, rows, args.seed)
    _sync(torch, dev)
    info["init_s"] = time.time() - t0

    # the loss at the init masters, bf16 against fp64
    t0 = time.time()
    l16 = _mean_loss(torch, model, masters, batch, mb)
    l64 = _mean_loss(torch, build_model(dataclasses.replace(
        cfg, dtype="float64"), device=dev), masters, batch, mb)
    info["loss"] = dict(bf16=l16, fp64=l64,
                        rel_err=abs(l16 - l64) / abs(l64))
    info["loss_s"] = time.time() - t0
    if not info["loss"]["rel_err"] <= BF16_LOSS_RTOL:
        return (f"{name}: the bf16 loss lies {info['loss']['rel_err']:.3g} "
                f"from fp64's (rule {BF16_LOSS_RTOL})"), info
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the fp32 gradient against fp64's, one group deep, q and k tempered
    t0 = time.time()
    cfg_g = dataclasses.replace(cfg, **FAMILY_GRAD_DEPTH[name])
    tempered = _tempered_qk(build_model(cfg_g, device=dev).init_masters(args.seed))
    part = {k: torch.as_tensor(v, device=dev)[:FAMILY_GRAD_ROWS]
            for k, v in batch.items()}
    runs, secs = {}, {}
    for dt in ("float64", "float32"):
        t1 = time.time()
        runs[dt] = loss_and_grads(build_model(dataclasses.replace(
            cfg_g, dtype=dt), dev), tempered, part, 1)
        _sync(torch, dev)
        secs[dt] = time.time() - t1
    g64, g32 = runs["float64"][1], runs["float32"][1]
    leaves = {k: _rms(g32[k].double() - g64[k]) / max(_rms(g64[k]), 1e-300)
              for k in g64}
    info["grads"] = dict(
        layers=cfg_g.num_layers, enc_layers=cfg_g.enc_layers,
        rows=FAMILY_GRAD_ROWS, leaves=leaves, seconds=secs,
        worst=max(leaves.items(), key=lambda kv: kv[1]),
        loss_rel_err=abs(float(runs["float32"][0]) - float(
            runs["float64"][0])) / abs(float(runs["float64"][0])))
    info["grads_s"] = time.time() - t0
    del runs, g64, g32, tempered
    bad = [k for k, v in leaves.items() if not v <= FP64_GRAD_RTOL]
    if bad:
        return (f"{name}: the fp32 gradient of {bad} lies further than "
                f"{FP64_GRAD_RTOL} (RMS) from fp64's"), info
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    if name.startswith("xlstm"):
        t0 = time.time()
        ok, info["slstm_function"] = check_slstm_function(
            torch, dev, cfg, masters, rows // mb, seq, args.seed)
        info["slstm_function_s"] = time.time() - t0
        if not ok:
            return (f"{name}: the graphed SLSTMScan differs from its step by "
                    f"step run: {info['slstm_function']['max_rel_diff']}"), \
                info
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # FAMILY_STEPS steps on the batch
    tc = TrainConfig(learning_rate=FAMILY_LR, warmup_steps=FAMILY_WARMUP,
                     total_steps=10 * FAMILY_STEPS, microbatches=mb,
                     seed=args.seed)
    state_dtype = FAMILY_STATE.get(name, "float32")
    step = make_train_step(model, tc, state_dtype)
    info["state_dtype"] = state_dtype
    if name in FAMILY_TEMPERED_STEPS:
        masters = _tempered_qk(masters)
    info["steps_from"] = "tempered" if name in FAMILY_TEMPERED_STEPS \
        else "init"
    params, opt = masters, O.init_adam(masters, state_dtype)
    del masters
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses, step_s, norms = [], [], []
    for _ in range(FAMILY_STEPS):
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        losses.append(float(met["loss"]))
        step_s.append(time.perf_counter() - t0)
        norms.append(float(met["grad_norm"]))
    info["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 \
        if dev.type == "cuda" else 0.0
    med = float(np.median(step_s[1:]))
    shape = ShapeConfig("q", seq, rows, "train")
    info.update(losses=losses, grad_norms=norms, step_s_all=step_s,
                first_step_s=step_s[0], step_s=med,
                tokens_per_s=seq * rows / med,
                model_flops=model_flops_for(cfg, shape),
                mfu=model_flops_for(cfg, shape) / med / peak_flops("bf16"))
    finite = bool(np.isfinite(losses).all()) and all(
        bool(torch.isfinite(t).all()) for t in params.values())
    if not finite:
        return f"{name}: a step was not finite: losses {losses}", info
    if not losses[-1] < losses[0]:
        return (f"{name}: the last step's loss {losses[-1]:.4f} is not below "
                f"the first's {losses[0]:.4f}"), info
    if name.startswith("hymba"):
        info["mamba_saved"] = hymba_scan_saved(torch, dev, cfg, params,
                                               rows // mb, seq, args.seed)

    if name.startswith("xlstm"):
        # one checkpoint of the trained state, saved and restored
        root = tempfile.mkdtemp(prefix="family_ckpt_")
        try:
            ck = C.Checkpointer(root)
            tree = (params, opt)
            t0 = time.time()
            ck.save(FAMILY_STEPS, tree, extra={"step": FAMILY_STEPS},
                    block=True)
            info["save_s"] = time.time() - t0
            sdir = os.path.join(root, f"step_{FAMILY_STEPS}")
            info["checkpoint_gib"] = sum(
                os.path.getsize(os.path.join(sdir, f))
                for f in os.listdir(sdir)) / 2 ** 30
            t0 = time.time()
            back, extra = ck.restore(FAMILY_STEPS, tree)
            info["restore_s"] = time.time() - t0
            want, got = C._flatten(tree), C._flatten(back)
            diff = [k for k in want if not torch.equal(got[k], want[k])]
            info["restored_arrays"] = len(got)
            del back, got
            if sorted(want) != sorted(C._flatten(tree)) or diff or \
                    extra.get("step") != FAMILY_STEPS:
                return (f"{name}: the restored checkpoint differs in "
                        f"{diff[:5]} (of {len(want)})"), info
        finally:
            shutil.rmtree(root, ignore_errors=True)
    return None, info


def drive_compressed_step(args, dev):
    """The compressed cross-pod step (``make_compressed_train_step``) of
    ``TRAIN_ARCH`` at full size over ``pod_mesh(COMPRESS_PODS)`` on the
    card, beside one plain ``make_train_step`` on the same batch (16 x
    ``TRAIN_SEQ`` SyntheticLM tokens, one microbatch, lr 1e-3 after 1
    warmup step): the reference's own bounds, |loss_plain -
    loss_compressed| < ``COMPRESS_LOSS_TOL`` and every parameter within
    ``COMPRESS_PARAM_TOL`` of the plain step's. Then ``COMPRESS_STEPS``
    more compressed steps on the next batches: finite, every pod's error
    buffer of every leaf non-zero. Returns (error or None, info)."""
    import numpy as np
    import torch
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data.pipeline import PipelineSpec, SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.sharding import pod_mesh
    from repro_torch.train.compression import (init_error_tree,
                                               make_compressed_train_step)
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.step import make_train_step

    cfg = get_config(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    masters = model.init_masters(args.seed)
    data = SyntheticLM(PipelineSpec(cfg.vocab_size, TRAIN_SEQ, 16,
                                    seed=args.seed))
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=1, microbatches=1)
    mesh = pod_mesh(COMPRESS_PODS, dev)
    plain = make_train_step(model, tc)
    comp = make_compressed_train_step(model, tc, mesh)
    opt = init_adam(masters)
    err = init_error_tree(masters, mesh)
    info = dict(pods=COMPRESS_PODS, n_params=model.n_params())
    batch = data.batch(0)
    t0 = time.perf_counter()
    p1, _, m1 = plain(masters, opt, batch)
    l1 = float(m1["loss"])
    info["plain_step_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2, o2, e2, m2 = comp(masters, opt, err, batch)
    l2 = float(m2["loss"])
    info["compressed_step_s"] = time.perf_counter() - t0
    info.update(loss_plain=l1, loss_compressed=l2, loss_diff=abs(l1 - l2),
                max_param_diff=max(float((p1[k] - p2[k]).abs().max())
                                   for k in p1))
    del p1
    if not (info["loss_diff"] < COMPRESS_LOSS_TOL and
            info["max_param_diff"] < COMPRESS_PARAM_TOL):
        return (f"compressed step: loss {l2} against the plain step's {l1}, "
                f"largest parameter difference {info['max_param_diff']} "
                f"(bounds {COMPRESS_LOSS_TOL}, {COMPRESS_PARAM_TOL})"), info
    losses, secs = [l2], []
    for s in range(1, COMPRESS_STEPS + 1):
        t0 = time.perf_counter()
        p2, o2, e2, m2 = comp(p2, o2, e2, data.batch(s))
        losses.append(float(m2["loss"]))
        secs.append(time.perf_counter() - t0)
    zero = [k for k, e in e2.items()
            if not all(bool(e[i].abs().max() > 0) for i in range(
                COMPRESS_PODS))]
    finite = bool(np.isfinite(losses).all()) and all(
        bool(torch.isfinite(t).all()) for t in p2.values())
    info.update(losses=losses, step_s_all=secs, count=int(o2.count),
                error_rms={k: _rms(e) for k, e in list(e2.items())[:4]},
                pods_differ=sum(not torch.equal(e[0], e[1])
                                for e in e2.values()), leaves=len(e2))
    if not finite or zero:
        return (f"compressed steps: finite {finite}, error buffers all zero "
                f"on a pod in {zero[:5]}"), info
    return None, info


def drive_family_train_path(args, dev):
    """Path (q): ``drive_family_train`` for each of ``FAMILY_RUNS``, the
    state freed before the next, then ``drive_compressed_step``. Returns
    (error or None, {name: info})."""
    import torch
    out = {}
    for name, depth, seq, rows, mb in FAMILY_RUNS:
        t0 = time.time()
        err, info = drive_family_train(args, dev, name, depth, seq, rows, mb)
        info["seconds"] = time.time() - t0
        out[name] = info
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if err:
            return err, out
    t0 = time.time()
    err, info = drive_compressed_step(args, dev)
    info["seconds"] = time.time() - t0
    out["compressed"] = info
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return err, out


def log_family_path(fam: dict, card: str) -> None:
    """Path (q)'s lines, each beside the card's name and power limit."""
    for name, info in fam.items():
        if name == "compressed":
            log(f"family training path, compressed step ({TRAIN_ARCH}, "
                f"{info.get('pods')} pods; {card}): " + json.dumps(info))
            continue
        log(f"family training path, {name} ({info.get('layers')} layers"
            + (f" + {info['enc_layers']} encoder" if info.get("enc_layers")
               else "") + f", {info.get('rows')} x {info.get('seq')} tokens "
            f"in {info.get('microbatches')} microbatches, bf16 compute, fp32 "
            f"masters, block remat; {card}): " + json.dumps(
                {k: v for k, v in info.items()
                 if k not in ("grads", "slstm_function")}, default=str))
        if "step_s" in info:
            log(f"  {name}: step {info['step_s']:.4f} s (median after the "
                f"first, {info['first_step_s']:.2f} s), "
                f"{info['tokens_per_s']:.0f} tokens/s, MFU "
                f"{info['mfu']:.4f} of the bf16 peak, peak device memory "
                f"{info['peak_gib']:.2f} GiB; {card}")
        if "grads" in info:
            g = info["grads"]
            log(f"  {name}: fp32 gradient against fp64 at {g['layers']}"
                + (f" + {g['enc_layers']}" if g.get("enc_layers") else "")
                + f" layers on {g['rows']} rows, q and k tempered, leaf RMS "
                f"error over leaf RMS (rule {FP64_GRAD_RTOL}; seconds "
                + json.dumps(g["seconds"]) + "): worst "
                + json.dumps(g["worst"]) + "; all " + json.dumps(g["leaves"]))
        if "slstm_function" in info:
            log(f"  {name}: SLSTMScan graphed against step by step on the "
                f"card; {card}: " + json.dumps(info["slstm_function"]))


def run_family_train_path(args, dev, kmods, card: str, starts) -> int:
    """Path (q) inside ``main``: its counts reset before it, its lines
    logged, no kernel of the port launched on it (train mode is dense
    attention). Returns 0, or ``fail``'s code."""
    import torch
    starts.append(("family training path", time.time()))
    _reset(kmods)
    err, fam = drive_family_train_path(args, dev)
    launches = _counters(kmods)
    gc.collect()
    torch.cuda.empty_cache()
    log_family_path(fam, card)
    log("launches on the family training path: " + json.dumps(launches))
    if err:
        return fail(f"family training path: {err}")
    if any(launches.values()):
        return fail(f"a kernel of the port launched on the family training "
                    f"path, which the reference trains without one: "
                    f"{launches}")
    if args.path == "q":
        starts.append(("end", time.time()))
        log("seconds by section: " + json.dumps(
            {a[0]: round(b[1] - a[1], 1) for a, b in zip(starts, starts[1:])}))
    return 0


# ------------------------------------------- (b) HIBOG and split_lpgf
def small_blobs(seed: int, rows: int, dim: int):
    """``rows`` x ``dim`` Gaussian blobs around 12 centres (the law
    ``build_platform`` draws its tables by), from their own seed."""
    import numpy as np
    rng = np.random.default_rng(seed + 11)
    centers = rng.normal(size=(12, dim)).astype(np.float32) * 6
    return (centers[rng.integers(0, 12, rows)]
            + rng.normal(size=(rows, dim))).astype(np.float32)


def grid_points(seed: int, rows: int, dim: int):
    """``rows`` x ``dim`` points of {-0.5, -0.25, 0, 0.25, 0.5}: every
    squared distance between them, and between HIBOG's moved points
    (multiples of 1/64, two iterations), is an exact fp32 sum on either
    side, so the kernel and the plain version pick the same neighbours,
    ties by index."""
    import numpy as np
    rng = np.random.default_rng(seed + 13)
    return (rng.integers(-2, 3, (rows, dim)) * 0.25).astype(np.float32)


def cpu_split_tree(seed: int, rows: int, dim: int, out: str) -> None:
    """``build_index(split_lpgf=True)`` of ``small_blobs`` on the CPU, its
    permutation and node structure saved to ``out`` (run in a process of
    its own beside the card's phases)."""
    import numpy as np
    import torch
    sys.path.insert(0, SRC)
    from repro_torch.core.index import build_index
    torch.set_num_threads(6)
    tree, perm, _ = build_index(small_blobs(seed, rows, dim),
                                split_lpgf=True, device="cpu")
    np.savez(out, perm=perm, parent=tree.parent, is_leaf=tree.is_leaf,
             bucket_start=tree.bucket_start, bucket_end=tree.bucket_end)


def _helper(code: str, log_path: str):
    """``python -c code`` in a process of its own, beside the script, on
    the CPU only; its output into ``log_path``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, ROOT]),
               CUDA_VISIBLE_DEVICES="")
    f = open(log_path, "w")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=f, stderr=subprocess.STDOUT), f


def _finish(proc, f, timeout: float) -> int:
    """Wait for a helper (killed at ``timeout`` s); its exit code."""
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    f.close()
    return rc


def drive_build_options(args, dev, kmods):
    """Path (b)'s build options on ``args.small_rows`` rows:
    ``hibog(x, iters=2)`` on the card over ``grid_points`` (at least two
    ``topk_l2`` launches; each iteration's neighbour ids equal to the
    plain version's on the same card input; the moved points within 1e-5
    (relative to their largest magnitude) of the same call on the CPU;
    on Gaussian points the fp32 expansion's order of near-tied
    neighbours differs between the kernel's tile and the library GEMM),
    then ``build_index(split_lpgf=True)`` on the card over ``small_blobs``:
    a valid tree
    (every row in exactly one leaf bucket), whose ``BatchedExecutor``
    returns the brute force's rows for 32 V.K queries at k = 20, its
    ``pairwise_sq_l2`` launches counted. Returns (error or None, info,
    (tree, perm) for ``equals_cpu_tree``)."""
    import numpy as np
    import torch
    from repro_torch.core import lpgf
    from repro_torch.core import query as Q
    from repro_torch.core.index import BatchedExecutor, build_index
    from repro_torch.core.lake import MMOTable
    from repro_torch.kernels import ops, ref

    g = grid_points(args.seed, args.small_rows, args.dim)
    info = {"rows": len(g), "dim": args.dim}
    calls, real = [], ops.topk_l2_blocked

    def recording(q, p, k, row_block=2048):
        d, i = real(q, p, k, row_block)
        calls.append((q, p, k, i))
        return d, i
    _reset(kmods)
    ops.topk_l2_blocked = recording
    try:
        t0 = time.time()
        moved = lpgf.hibog(g, iters=2, device=dev)
        _sync(torch, dev)
        info["hibog_s"] = time.time() - t0
    finally:
        ops.topk_l2_blocked = real
    info["hibog_launches"] = _counters(kmods)
    same = [bool(torch.equal(i, ref.topk_l2(q, p, k)[1]))
            for q, p, k, i in calls]
    del calls
    info["hibog_ids_equal_plain"] = same
    t0 = time.time()
    on_cpu = lpgf.hibog(g, iters=2, device="cpu")
    info["hibog_cpu_s"] = time.time() - t0
    rel = float(np.abs(moved - on_cpu).max() / np.abs(on_cpu).max())
    info["hibog_vs_cpu"] = rel
    if info["hibog_launches"]["topk_l2"] < 2:
        return f"hibog launched topk_l2 fewer than twice: {info}", info, \
            None
    if not all(same) or len(same) != 2:
        return f"hibog's neighbour ids differ from the plain version's: " \
            f"{info}", info, None
    if not rel <= 1e-5:
        return f"hibog on the card differs from the CPU's by {rel}", info, \
            None

    x = small_blobs(args.seed, args.small_rows, args.dim)
    _reset(kmods)
    t0 = time.time()
    tree, perm, rep = build_index(x, split_lpgf=True, device=dev)
    _sync(torch, dev)
    info["split_build_s"] = time.time() - t0
    info["split_launches"] = _counters(kmods)
    info["leaves"] = int(rep.n_leaves)
    leaves = np.flatnonzero(tree.is_leaf)
    spans = sorted(zip(tree.bucket_start[leaves], tree.bucket_end[leaves]))
    valid = (np.array_equal(np.sort(perm), np.arange(len(x)))
             and spans[0][0] == 0 and spans[-1][1] == len(x)
             and all(a[1] == b[0] for a, b in zip(spans, spans[1:])))
    info["valid_tree"] = bool(valid)
    feats = x[perm]
    rng = np.random.default_rng(args.seed + 12)
    qs = (feats[rng.integers(0, len(feats), 32)]
          + rng.normal(0, 0.01, (32, feats.shape[1]))).astype(np.float32)
    _, rows, _ = BatchedExecutor(tree, feats, device=dev).knn(qs, 20)
    table = MMOTable("split").add_vector("e", feats)
    bad = [i for i, q in enumerate(qs) if not np.array_equal(
        rows[i], Q.execute_bruteforce(table, Q.VK.of("e", q, 20)))]
    info["query_mismatches"] = len(bad)
    if not valid:
        return f"split_lpgf's tree is not valid: {info}", info, None
    if bad:
        return f"split_lpgf's tree answers {len(bad)} queries otherwise " \
            f"than the brute force: {info}", info, None
    if info["split_launches"]["pairwise_sq_l2"] <= 0:
        return f"split_lpgf's build launched no pairwise_sq_l2: {info}", \
            info, None
    return None, info, (tree, perm)


def equals_cpu_tree(helper, tree_file: str, built):
    """Whether the card's split tree ``built`` ((tree, perm)) equals the
    CPU's (``cpu_split_tree``, waited for here), or why it is unknown."""
    import numpy as np
    rc = _finish(*helper, timeout=600)
    if rc:
        return f"the CPU build failed (exit {rc})"
    cpu = np.load(tree_file)
    tree, perm = built
    return bool(np.array_equal(cpu["perm"], perm) and all(
        np.array_equal(cpu[f], getattr(tree, f))
        for f in ("parent", "is_leaf", "bucket_start", "bucket_end")))


# ------------------------------------------------------ (r) the dry run
DRY_ARCH = "llama3-8b"
DRY_LAYERS = 2            # of llama3-8b's 32, at its published width
# cut for the script's time limit, in this order (it ran ~830 s without
# the cuts): (1) the decode cell (a 32,768 cache, batch 8) dropped, (2)
# the full-size cells llama3-8b train_4k on 2 x 16 x 16 and arctic-480b
# train_4k dropped, (3) the prefill at seq 16,384, not 32,768
DRY_CELLS = (("train", 4096, 4), ("prefill", 16384, 1))
# full-size cells traced beside the card's phases
DRY_FULL = (("llama3-8b", "train_4k", False),)
DRY_ALLOC = 512           # the allocator's rounding: bytes a block
DRY_UNSPLIT = 2 ** 20     # a large block's remainder it does not split
DRY_PEAK_RTOL = 0.25      # measured peak against argument + temp bytes
DRY_FLOP_RTOL = 0.01      # matmul FLOPs against the profiler's
DRY_REPS = 3              # timed steps after a warm one
DRY_FLASH_ROWS = 1024     # queries a block when flash is held (prefill)
MM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def _leaf_tensors(tree):
    """The tensors of an argument tree (dicts, tuples, dataclasses)."""
    import dataclasses
    import torch
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaf_tensors(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaf_tensors(v)]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in _leaf_tensors(getattr(tree, f.name))]
    return []


def drive_dry_cell(args, dev, fa, ref, kind: str, seq: int, batch: int):
    """One cut cell of path (r): llama3-8b at its published width and
    ``DRY_LAYERS`` layers on ``make_dev_mesh(1, 1)``. The dry run predicts
    it on fake tensors; then the same step runs on the card: (1) the
    arguments' requests (the allocator's ``requested_bytes``) equal the
    predicted argument bytes within ``DRY_ALLOC`` a leaf, one block a
    leaf on the card, and the growth of ``memory_allocated`` exceeds them
    by no more than the allocator's rounding (``DRY_ALLOC`` a block, and
    ``DRY_UNSPLIT`` a large block); (2) the counter run live
    on the card gives the trace's FLOPs exactly, and its matmul FLOPs
    (the total less the kernels' charges) equal ``torch.profiler``'s
    ``with_flops`` sum over the ``MM_OPS`` within ``DRY_FLOP_RTOL``, taken
    over the products the step dispatched (block remat's recomputation
    stops early, aborting its last product, which the profiler records
    all the same); (3) the
    peak of ``max_memory_allocated`` above the memory before the
    arguments lies within ``DRY_PEAK_RTOL`` of argument + temp bytes; (4)
    the median of ``DRY_REPS`` steps after the counted one is no less
    than the roofline bound max(t_compute, t_memory). A prefill's flash
    launches are held to the plain version (``held_flash`` by blocks of
    ``DRY_FLASH_ROWS`` queries).
    Returns (error or None, info)."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_dev_mesh
    from repro_torch.utils import opcount

    cfg = dataclasses.replace(get_config(DRY_ARCH), num_layers=DRY_LAYERS)
    shape = ShapeConfig(f"{kind}_cut", seq, batch, kind)
    mesh = make_dev_mesh(1, 1)
    over = dryrun.overrides(DRY_ARCH, kind)
    pred = dryrun.dry_run(cfg, shape, mesh, over)
    mem, rf = pred["memory"], pred["roofline"]
    info = {"kind": kind, "seq": seq, "batch": batch,
            "trace_s": pred["trace_s"], "predicted": dict(
                argument_bytes=mem["argument_bytes"],
                temp_bytes=mem["temp_bytes"],
                flops=rf["flops_per_dev"], bytes=rf["bytes_per_dev"],
                t_compute=rf["t_compute"], t_memory=rf["t_memory"],
                bottleneck=rf["bottleneck"],
                roofline_fraction=rf["roofline_fraction"])}
    prog = dryrun.program(cfg, shape, mesh, over, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()
    base = torch.cuda.memory_allocated()
    a = dryrun.make_args(prog, seed=args.seed)
    torch.cuda.synchronize()
    after = torch.cuda.memory_stats()
    placed = torch.cuda.memory_allocated() - base
    requested = (after["requested_bytes.all.current"]
                 - before["requested_bytes.all.current"])
    blocks = (after["allocation.all.current"]
              - before["allocation.all.current"])
    large = (after["allocation.large_pool.current"]
             - before["allocation.large_pool.current"])
    leaves = _leaf_tensors(a)
    info["placed_bytes"] = placed
    info["requested_bytes"] = requested
    info["leaves"] = len(leaves)
    info["blocks"] = blocks
    info["large_blocks"] = large
    # the arguments' requests, as the allocator records them, are the
    # predicted bytes to its rounding (512 bytes a leaf), one block each;
    # memory_allocated counts each block whole, and after the earlier
    # paths a large block carved from a cached free one keeps the
    # remainder the allocator does not split off (under 1 MiB)
    ok1 = (abs(requested - mem["argument_bytes"]) <= DRY_ALLOC * len(leaves)
           and blocks == sum(t.is_cuda for t in leaves)
           and 0 <= placed - requested <= DRY_ALLOC * blocks
           + DRY_UNSPLIT * large)

    # a prefill's flash launches held first, in a step of their own, then
    # a step counted live and one profiled
    checks = []
    if kind == "prefill":
        with held_flash(torch, fa, ref, "wgmma", True,
                        rows=DRY_FLASH_ROWS) as checks:
            out = prog.step(*a)
            torch.cuda.synchronize()
        del out
    dispatched = collections.Counter()
    with opcount.count_ops(fake=False) as counter, \
            _DotRecorder(dispatched):
        out = counter.run(prog.step, *a)
        torch.cuda.synchronize()
    del out
    # profiled apart: under the counter's dispatch mode the profiler
    # records each operator twice (its call and the mode's re-dispatch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True, record_shapes=True) as prof:
        out = prog.step(*a)
        torch.cuda.synchronize()
    del out
    live = counter.stats
    kern = sum(k["flops"] for k in live.kernels.values())
    # the profiler also records, with its FLOPs, a product that block
    # remat's early stop aborts (the recomputation's saved-tensor hook
    # raises before the product runs): its sum is taken over the recorded
    # products that the counted step dispatched, signature by signature
    prof_mm, extra = _dispatched_flops(prof, dispatched)
    info["profiler_matmul_flops_recorded"] = sum(
        e.flops for e in prof.events() if e.name in MM_OPS)
    info["profiler_matmul_not_dispatched"] = extra
    del prof
    info["live_flops"] = live.flops
    info["kernel_charges"] = live.kernels
    info["matmul_flops"] = live.flops - kern
    info["profiler_matmul_flops"] = prof_mm
    ok2 = live.flops == rf["flops_per_dev"] and abs(
        live.flops - kern - prof_mm) <= DRY_FLOP_RTOL * max(prof_mm, 1.0)
    info["flash_held"] = [c[:6] for c in checks]
    ok_flash = kind != "prefill" or (
        len(checks) == DRY_LAYERS and all(c[2] and c[5] for c in checks))

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(DRY_REPS):
        t0 = time.time()
        out = prog.step(*a)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
        del out
    peak = torch.cuda.max_memory_allocated() - base
    want = mem["argument_bytes"] + mem["temp_bytes"]
    info["peak_bytes"] = peak
    info["argument_plus_temp_bytes"] = want
    ok3 = abs(peak - want) <= DRY_PEAK_RTOL * want
    step = float(np.median(times))
    bound = max(rf["t_compute"], rf["t_memory"])
    info["step_s"] = step
    info["steps_s"] = times
    info["bound_s"] = bound
    info["of_the_bound"] = bound / step
    ok4 = step >= bound
    info["checks"] = dict(argument_bytes=ok1, flops=ok2, peak=ok3,
                          bound=ok4, flash=ok_flash)
    del a, prog
    gc.collect()
    torch.cuda.empty_cache()
    if not all(info["checks"].values()):
        return f"dry run {kind} cell: {info['checks']}", info
    return None, info


def _dot_key(name: str, shapes) -> tuple:
    return (name, tuple(tuple(x) for x in shapes if x))


def _DotRecorder(into):
    """A dispatch mode counting, by ``_dot_key``, each product (``MM_OPS``)
    that reaches dispatch: what ran, whatever the counter weights."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Recorder(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = f"aten::{func.overloadpacket.__name__}"
            if name in MM_OPS:
                into[_dot_key(name, [tuple(t.shape) for t in args
                                     if isinstance(t, torch.Tensor)])] += 1
            return func(*args, **(kwargs or {}))
    return Recorder()


def _dispatched_flops(prof, dispatched):
    """The profiler's FLOPs over its recorded products (``MM_OPS``), each
    signature counted as often as the step dispatched it; and how many
    recorded products had no dispatch (aborted before they ran)."""
    by_key = {}
    for e in prof.events():
        if e.name in MM_OPS:
            by_key.setdefault(_dot_key(e.name, e.input_shapes), []).append(
                e.flops)
    total, extra = 0, 0
    for key, flops in by_key.items():
        n = min(len(flops), dispatched.get(key, 0))
        total += sum(flops[:n])
        extra += len(flops) - n
    return total, extra


def drive_dryrun_path(args, dev, fa, ref, cells_dir: str, helper):
    """Path (r): each of ``DRY_CELLS`` through ``drive_dry_cell``, then the
    full-size cells ``DRY_FULL`` that ``helper`` traced meanwhile with
    ``dryrun.run_cells`` into ``cells_dir``: each one's memory per device
    and bottleneck. Returns (error or None, info)."""
    info = {"cells": [], "full": {}}
    for kind, seq, batch in DRY_CELLS:
        err, cell = drive_dry_cell(args, dev, fa, ref, kind, seq, batch)
        info["cells"].append(cell)
        if err:
            return err, info
    rc = _finish(*helper, timeout=600)
    for arch, shape, multi in DRY_FULL:
        tag = f"{arch}__{shape}__{'multi' if multi else 'single'}"
        path = os.path.join(cells_dir, tag + ".json")
        if not os.path.exists(path):
            return f"the dry run of {tag} wrote no result (exit {rc})", info
        with open(path) as f:
            res = json.load(f)
        info["full"][tag] = dict(
            mem_per_dev_gib=res["memory"]["peak_per_device_bytes"] / 2 ** 30,
            bottleneck=res["roofline"]["bottleneck"],
            trace_s=res["trace_s"], split=res["roofline"]["split"],
            collective_bytes_per_dev=res["roofline"][
                "collective_bytes_per_dev"])
    if rc:
        return f"dryrun.run_cells exited {rc}", info
    return None, info


def run_dryrun_paths(args, dev, kmods, fa, ref, card: str, starts) -> int:
    """(b)'s build options and path (r) inside ``main``, with their two
    CPU helpers (the CPU's split tree, the full-size dry-run cells)
    started first, so they run beside the card's phases. Returns 0, or
    ``fail``'s code."""
    import tempfile
    import torch
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dry_")
    tree_file = os.path.join(tmp, "cpu_tree.npz")
    cells_dir = os.path.join(tmp, "cells")
    tree_helper = _helper(
        f"import chip_smoke; chip_smoke.cpu_split_tree({args.seed}, "
        f"{args.small_rows}, {args.dim}, {tree_file!r})",
        os.path.join(tmp, "tree.log"))
    cells_helper = _helper(
        "import sys; from repro_torch.launch import dryrun; "
        f"sys.exit(0 if dryrun.run_cells({list(DRY_FULL)!r}, "
        f"{cells_dir!r}) else 1)", os.path.join(tmp, "cells.log"))
    try:
        starts.append(("build options (b)", time.time()))
        err, bo, built = drive_build_options(args, dev, kmods)
        log(f"build options on the small table ({bo.get('rows')} x "
            f"{bo.get('dim')}; {card}): " + json.dumps(bo))
        if err:
            return fail(f"build options: {err}")
        gc.collect()
        torch.cuda.empty_cache()
        starts.append(("dry-run path (r)", time.time()))
        _reset(kmods)
        err, dr = drive_dryrun_path(args, dev, fa, ref, cells_dir,
                                    cells_helper)
        launches = _counters(kmods)
        for c in dr["cells"]:
            log(f"dry run, {DRY_ARCH} at {DRY_LAYERS} layers, {c['kind']} "
                f"(seq {c['seq']}, batch {c['batch']}; {card}): "
                + json.dumps(c, default=str))
            if "step_s" in c:
                p = c["predicted"]
                log(f"  {c['kind']}: arguments {c['requested_bytes']} bytes "
                    f"requested ({c['placed_bytes']} allocated), "
                    f"{p['argument_bytes']} predicted; peak "
                    f"{c['peak_bytes'] / 2**30:.3f} GiB, argument + temp "
                    f"{c['argument_plus_temp_bytes'] / 2**30:.3f} GiB; "
                    f"FLOPs {c['live_flops']:.6e} live = trace, matmul "
                    f"{c['matmul_flops']:.6e} against the profiler's "
                    f"{c['profiler_matmul_flops']:.6e}; step "
                    f"{c['step_s']:.4f} s, bound {c['bound_s']:.4f} s "
                    f"({p['bottleneck']}), of the bound "
                    f"{c['of_the_bound']:.3f}, roofline_fraction "
                    f"{p['roofline_fraction']:.3f}")
        for tag, r in dr["full"].items():
            log(f"dry run, full-size cell {tag}: {r['mem_per_dev_gib']:.2f} "
                f"GiB a device, bottleneck {r['bottleneck']}, trace "
                f"{r['trace_s']} s (CPU), split {r['split']}, collective "
                f"bytes a device {r['collective_bytes_per_dev']}")
        log("launches on the dry-run path: " + json.dumps(launches))
        log("split_lpgf's tree on the card equals the CPU's (built "
            "meanwhile): " + json.dumps(equals_cpu_tree(
                tree_helper, tree_file, built)))
        if err:
            return fail(f"dry-run path: {err}")
        if launches["flash_attention_wgmma"] < DRY_LAYERS:
            return fail(f"the dry-run path's prefill launched the wgmma "
                        f"flash kernel {launches['flash_attention_wgmma']} "
                        f"times")
    finally:
        for proc, f in (tree_helper, cells_helper):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    if args.path == "r":
        starts.append(("end", time.time()))
        log("seconds by section: " + json.dumps(
            {a[0]: round(b[1] - a[1], 1) for a, b in zip(starts, starts[1:])}))
    return 0


# ---------------------------------------------------- (s) the examples
# train_embedder's flags: the published width, 30 steps (cut from 60 for
# the time limit, PERF.md §4)
EXAMPLE_TRAIN = ("--full", "--steps", "30")
# the kernels each example must launch (counts reset before it)
EXAMPLE_KERNELS = {
    "quickstart": ("pairwise_sq_l2", "topk_l2"),
    "precision_scan": ("pairwise_sq_l2", "topk_l2", "topk_l2_masked",
                       "quant_lb2"),
    "query_aware_tuning": ("pairwise_sq_l2",),
    "serve_retrieval": ("pairwise_sq_l2", "topk_l2", "topk_l2_masked",
                        "flash"),
    "serve_pipelined": ("pairwise_sq_l2", "topk_l2", "topk_l2_masked"),
    "serve_sharded": ("pairwise_sq_l2", "topk_l2", "topk_l2_masked"),
    "train_embedder": ("pairwise_sq_l2", "topk_l2", "lpgf_force"),
    "smoke_models": ("flash",),
}


def oracle_misses(table, queries, rows, row_ids, extra=None) -> list:
    """Indices of the queries whose rows, mapped to logical ids through
    ``row_ids`` (None: taken as they are) and taken as sets, differ from
    ``query.execute_bruteforce`` over ``table``'s raw columns with
    ``extra`` ({column: rows}) appended: the plain reference."""
    import numpy as np
    from repro_torch.core import query as Q
    from repro_torch.core.lake import MMOTable
    extra = extra or {}
    t = MMOTable(table.name)
    for k, v in table.vector.items():
        t.add_vector(k, np.concatenate([v, extra[k]]) if k in extra else v)
    for k, v in table.numeric.items():
        t.add_numeric(k, np.concatenate([v, extra[k]]) if k in extra else v)
    bad = []
    for i, (q, r) in enumerate(zip(queries, rows)):
        got = np.asarray(r) if row_ids is None else row_ids[np.asarray(r)]
        if set(got.tolist()) != set(Q.execute_bruteforce(t, q).tolist()):
            bad.append(i)
    return bad


def _request_queries(Q, reqs, vecs):
    return [Q.VK.of(r.attr, v, r.k) if r.predicate is None else
            Q.And.of(r.predicate, Q.VK.of(r.attr, v, r.k))
            for r, v in zip(reqs, vecs)]


def example_contract(name: str, out: dict):
    """(errors, figures) of one example's returned dict: every contract
    of the example held, every row held to ``oracle_misses``."""
    import numpy as np
    from repro_torch.core import query as Q
    from repro_torch.core.lake import MMOTable
    err, fig = [], {}

    def need(ok, what):
        if not ok:
            err.append(what)
    if name == "quickstart":
        need(out["exact"] and len(out["rows"]) == 10, "Fig. 1 rows")
        need(not oracle_misses(out["table"], [out["query"]], [out["rows"]],
                               out["row_ids"]), "Fig. 1 rows vs the oracle")
        need(out["uris"] == [f"s3://catalog/{i}.jpg" for i in
                             out["row_ids"][out["rows"][:3]]], "get_mmos")
        need(out["lake_tables"] == ["products"] and MMOTable.load(
            os.path.join(out["lake"], "products")).n_rows == 5000, "lake")
        fig = dict(cbr=out["cbr"], rows_scanned=out["rows_scanned"],
                   changed=out["changed"], qbs_score=out["qbs_score"])
    elif name == "precision_scan":
        for prec, run in out["precisions"].items():
            need(run["identical_to_fp32"], f"{prec} rows identical")
            need(not oracle_misses(out["table"], out["queries"], run["rows"],
                                   out["base_row_ids"]), f"{prec} oracle")
            fig[prec] = dict(qps=run["qps"], rescue=run["rescue"]["ratio"])
        need(out["precisions"]["int8"]["rescue"]["scanned"] > 0,
             "int8 scanned nothing")
        extra = dict(out["appended"])
        for key in ("delta_rows", "delta_rows_int8", "default_rows"):
            need(not oracle_misses(out["table"], out["queries"], out[key],
                                   out["delta_row_ids"], extra),
                 f"{key} vs the oracle")
        need(out["delta_identical"], "base+delta identical")
        need(out["default_mp_scanned"] > 0, "default int8 scanned nothing")
        fig.update(default_mp_scanned=out["default_mp_scanned"],
                   default_mp_rescued=out["default_mp_rescued"])
    elif name == "query_aware_tuning":
        need(out["n_swaps"] >= 1, f"no swap in {out['steps']} steps")
        need(set(out["checks"]) == {"serving", "swap", "fold", "final"},
             f"phases {sorted(out['checks'])}")
        need(out["exact"], "a phase's rows differ from the oracle")
        for phase, (n_rows, pairs) in out["checks"].items():
            extra = out.get("appended") if n_rows > 4000 else None
            got = [g for g, _ in pairs]
            need(not oracle_misses(out["table"], out["workload"][:4], got,
                                   None, extra), f"{phase} vs the oracle")
        fig = dict(steps=out["steps"], events=out["events"],
                   cbr_before=out["cbr_before"],
                   cbr_after=out.get("cbr_after"))
    elif name == "serve_retrieval":
        enh = MMOTable("enhanced").add_vector("e", out["enhanced"])
        need(not oracle_misses(enh, [Q.VK.of("e", q, 10) for q in
                                     out["knn_queries"]],
                               list(out["knn_rows"]), None),
             "batched KNN vs the oracle")
        need(out["cache"] == "hit" and out["n_engine"] == 64,
             "planned batch not a warm plan of 64 engine queries")
        need(not oracle_misses(out["table"], out["hybrid"],
                               out["hybrid_rows"], out["row_ids"]),
             "hybrid batch vs the oracle")
        need(not oracle_misses(out["table"], out["hybrid"][:20],
                               out["scalar_rows"], out["row_ids"]),
             "scalar queries vs the oracle")
        need(not oracle_misses(out["table"], _request_queries(
            Q, out["requests"], out["served_vectors"]), out["served_rows"],
            out["row_ids"]), "served requests vs the oracle")
        need(len(out["gen_tokens"]) == 4 and all(
            t.shape == (8,) for t in out["gen_tokens"]), "generation")
        fig = dict(knn_ms=out["knn_ms"], hybrid_qps=out["hybrid_qps"],
                   qbs_rows=out["qbs_rows"], served_ms=out["served_ms"],
                   prefill_ms=out["prefill_ms"], decode_ms=out["decode_ms"])
    elif name == "serve_pipelined":
        need(out["identical"], "depth 3 rows differ from depth 1")
        vecs = out["vectors"]
        reqs = out["requests"]
        need(not oracle_misses(out["table"], _request_queries(
            Q, reqs, [vecs[int(r.tokens[0]) % len(vecs)] + 0.01
                      for r in reqs]), out["rows"][1], out["row_ids"]),
             "served rows vs the oracle")
        need(out["inflight_after"] == 0 and
             out["resolved"] == out["pre_append"], "drain barrier")
        fig = dict(qps_depth_1=out["qps"][1], qps_depth_3=out["qps"][3],
                   gain=out["gain"], inflight_before=out["inflight_before"])
    elif name == "serve_sharded":
        for s, run in out["runs"].items():
            need(run["identical"], f"shards={s} rows differ")
            need(not oracle_misses(out["table"], out["queries"], run["rows"],
                                   out["row_ids"]), f"shards={s} oracle")
            fig[f"qps_shards_{s}"] = run["qps"]
        need(set(out["runs"]) == {"off", 1, 2, 8}, "a shard count skipped")
        need(out["server_shards"] == 2, "default_shards not taken")
        need(not oracle_misses(out["table"], _request_queries(
            Q, out["requests"], out["served_vectors"]), out["served_rows"],
            out["row_ids"]), "served requests vs the oracle")
    elif name == "train_embedder":
        ls = out["losses"]
        need(out["steps_run"] == int(EXAMPLE_TRAIN[-1]) and ls and
             all(np.isfinite(ls)), "steps run / finite losses")
        need(out["loss_last"] < out["loss_first"], "the loss did not fall")
        need(out["exact"] and not oracle_misses(
            out["table"], [out["query"]], [out["rows"]], out["row_ids"]),
            "hybrid query vs the oracle")
        fig = dict(losses=[round(x, 4) for x in ls],
                   loss_first=out["loss_first"], loss_last=out["loss_last"],
                   step_s_median=float(np.median(out["step_s"][1:])),
                   first_step_s=out["step_s"][0], chose=out["chose"],
                   scores=out["scores"], cbr=out["cbr"],
                   d_model=out["cfg"].d_model)
    elif name == "smoke_models":
        need(out["ok"], "a config failed: " + json.dumps(
            {k: v.get("error") for k, v in out["configs"].items()
             if not v["ok"]}))
        fig = {k: dict(loss=v.get("loss"), gnorm=v.get("gnorm"))
               for k, v in out["configs"].items()}
    return err, fig


def drive_examples_path(args, dev, kmods, card: str) -> int:
    """Path (s): each example's ``main(["--device", "cuda", ...])`` and
    ``scripts/smoke_models``, in this process, the launch counters reset
    before each and read after it; each held to its contract
    (``example_contract``) and to the kernels it must launch
    (``EXAMPLE_KERNELS``). Returns 0, or ``fail``'s code."""
    import io
    import shutil
    import tempfile
    import torch
    from repro_torch.examples import (precision_scan, query_aware_tuning,
                                      quickstart, serve_pipelined,
                                      serve_retrieval, serve_sharded,
                                      train_embedder)
    from repro_torch.scripts import smoke_models
    tmp = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    runs = (("quickstart", quickstart,
             ["--lake", os.path.join(tmp, "lake")]),
            ("precision_scan", precision_scan, []),
            ("query_aware_tuning", query_aware_tuning, []),
            ("serve_retrieval", serve_retrieval, []),
            ("serve_pipelined", serve_pipelined, []),
            ("serve_sharded", serve_sharded, []),
            ("train_embedder", train_embedder,
             list(EXAMPLE_TRAIN) + ["--ckpt", os.path.join(tmp, "ckpt")]),
            ("smoke_models", smoke_models, []))
    try:
        for name, mod, extra in runs:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            _reset(kmods)
            text = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(text):
                out = mod.main(["--device", str(dev)] + extra)
            torch.cuda.synchronize()
            secs = time.time() - t0
            launches = _counters(kmods)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            err, fig = example_contract(name, out)
            for line in text.getvalue().splitlines():
                log(f"  {name} | {line}")
            launches["flash"] = (launches["flash_attention"]
                                 + launches["flash_attention_wgmma"])
            missing = [k for k in EXAMPLE_KERNELS[name] if launches[k] <= 0]
            log(f"example {name} ({card}): " + json.dumps(dict(
                seconds=round(secs, 2), launches=launches, figures=fig,
                peak_gib=round(peak, 3)), default=str))
            if err:
                return fail(f"example {name}: " + "; ".join(err))
            if missing:
                return fail(f"example {name} never launched {missing}: "
                            f"{launches}")
            del out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def run_examples_path(args, dev, kmods, card: str, starts) -> int:
    """Path (s) inside ``main``, with its section time."""
    starts.append(("examples", time.time()))
    rc = drive_examples_path(args, dev, kmods, card)
    if rc or args.path != "s":
        return rc
    starts.append(("end", time.time()))
    log("seconds by section: " + json.dumps(
        {a[0]: round(b[1] - a[1], 1) for a, b in zip(starts, starts[1:])}))
    return 0

def log_kernel(label: str, ok: bool, row: dict) -> None:
    lib = row["library_ms"]
    log(f"kernel {label}: ok={ok} {row['shape']} ms={row['ms']:.4f} "
        f"plain_ms={row['plain_ms']:.4f} "
        f"library_ms={'none' if lib is None else f'{lib:.4f}'} "
        f"({row['library']}) "
        + (f"{row['tflops']:.1f} TFLOP/s of the function's operations, "
           f"host {row['host_ms']:.4f} ms per call "
           if "tflops" in row else "")
        + f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
        f"max_abs_err={row['max_abs_err']:.3g}"
        + (f" violations of lb2 <= exact d2: {row['violations']}; "
           f"kernel alone {row['kernel_ms']:.4f} ms, query quantization "
           f"in the wrapper {row['query_quantize_ms']:.4f} ms"
           if "violations" in row else ""))
    if "rounds_ms" in row:
        log(f"kernel {label}: 5 rounds of 10 launches, min "
            f"{row['rounds_ms'][0]:.4f} ms, median {row['ms']:.4f} ms: "
            + json.dumps(row["rounds_ms"]))
    if "lpgf_chunk" in row:
        log(f"kernel {label} at LPGF's chunk: "
            + json.dumps(row["lpgf_chunk"]))
        log(f"kernel {label} at the dense V.R mask's batch: "
            + json.dumps(row["vr_dense"]))
    if "merge_route_ms" in row:
        log(f"kernel {label}: the rank-merge route at the same shape "
            f"{row['merge_route_ms']:.4f} ms")
    if "stored" in row:
        log(f"kernel {label}: stored distances and calls on Gaussian "
            f"points: " + json.dumps(row["stored"]))
        log(f"kernel {label}: one call traced (torch.profiler): "
            + json.dumps(row["trace"]))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=200_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--small-rows", type=int, default=4096)
    ap.add_argument("--path", choices=["q", "r", "s"], default=None,
                    help="build, then run this path alone and stop (a "
                    "shorter call while the path is worked on; prints no "
                    "result line)")
    args = ap.parse_args()
    starts = []       # (section, start time): the seconds by path

    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail(f"no src/repro_torch beside {__file__}: run it from a "
                    f"checkout of the repository")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device: the port's kernels run on the card")
    sys.path.insert(0, SRC)
    from repro_torch.core import engine, lpgf
    from repro_torch.core import query as Q
    from repro_torch.kernels import (build, flash_attention, fused_topk,
                                     lpgf_force, pairwise_l2, quant_lb2, ref)
    from repro_torch.utils.quant import plan_tiles
    kmods = (pairwise_l2, fused_topk, quant_lb2, lpgf_force, flash_attention)

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
    starts.append(("build", time.time()))
    t0 = time.time()
    logs = build.build_all()
    log(f"build: {time.time() - t0:.1f} s")
    for name, out in logs.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "arning" in line:
                log(f"  {name}: {line.strip()}")
    # the wgmma kernel is built for both head dims with no spill
    spills = [int(n) for n in re.findall(
        r"(\d+) bytes spill (?:stores|loads)",
        logs["flash_attention_wgmma"])]
    log(f"flash_attention_wgmma: ptxas spill bytes {spills} (stores and "
        f"loads, hd 64 and 128)")
    if len(spills) != 4 or any(spills):
        return fail(f"flash_attention_wgmma: ptxas reports spills {spills}")
    # the shared distance tile's kernels: pairwise_sq_l2, both topk_l2
    # routes and the split merge, lpgf_force's four kernels, none spilling
    tile = {f: b for lib in ("pairwise_l2", "fused_topk", "lpgf_force")
            for f, b in build.spill_bytes(logs[lib]).items()
            if re.search(r"pairwise_sq_l2_kernel|topk_l2_split_kernel|"
                         r"topk_merge_kernel|lpgf_d2_kernel|"
                         r"lpgf_weights_kernel|transpose_kernel|"
                         r"lpgf_wx_kernel", f)}
    log(f"distance-tile kernels: ptxas spill bytes {sorted(tile.values())} "
        f"({len(tile)} kernels)")
    if len(tile) != 8 or any(tile.values()):
        return fail(f"distance-tile kernels: ptxas reports spills {tile}")
    # the SIMT flash kernel: two types at four head dims, none spilling
    simt = {f: b for f, b in build.spill_bytes(
        logs["flash_attention"]).items() if "flash_fwd" in f}
    log(f"flash_attention (SIMT): ptxas spill bytes {sorted(simt.values())} "
        f"({len(simt)} kernels)")
    if len(simt) != 8 or any(simt.values()):
        return fail(f"flash_attention (SIMT): ptxas reports spills {simt}")
    if args.path == "q":
        return run_family_train_path(args, dev, kmods, card, starts)
    if args.path == "r":
        return run_dryrun_paths(args, dev, kmods, flash_attention, ref, card,
                                starts)
    if args.path == "s":
        return run_examples_path(args, dev, kmods, card, starts)

    # -------------------------------------------------------- kernels
    starts.append(("kernels", time.time()))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    # the engine scans k plus its re-rank margin
    k_scan = 20 + engine._RERANK_EXTRA
    kernels = []
    for label, fn in (
            ("pairwise_sq_l2", lambda: check_pairwise(
                torch, pairwise_l2, ref, lpgf, dev, gen, args.rows,
                args.dim)),
            ("topk_l2", lambda: check_topk_l2(
                torch, fused_topk, pairwise_l2, ref, build, dev, gen,
                args.rows, args.dim)),
            ("topk_l2_masked", lambda: check_topk_masked(
                torch, fused_topk, ref, dev, gen, args.dim, k_scan)),
            ("quant_lb2 int8", lambda: check_quant_lb2(
                torch, quant_lb2, ref, build, plan_tiles, dev, gen,
                args.dim, "int8")),
            ("quant_lb2 bf16", lambda: check_quant_lb2(
                torch, quant_lb2, ref, build, plan_tiles, dev, gen,
                args.dim, "bf16")),
            ("lpgf_force", lambda: check_lpgf_force(
                torch, lpgf_force, pairwise_l2, ref, dev, gen, args.dim))):
        ok, row = fn()
        torch.cuda.synchronize()
        log_kernel(label, ok, row)
        if not ok:
            return fail(f"kernel {label} disagrees with its plain version")
        # quant_lb2's row is taken again at the widest round of its path
        if not label.startswith("quant_lb2"):
            kernels.append(row)
        torch.cuda.empty_cache()

    # NaN rows (the delta's unused capacity) through the distance tile
    ok, nan_info = check_nan_rows(torch, pairwise_l2, fused_topk,
                                  lpgf_force, ref, dev, gen, args.rows,
                                  args.dim)
    torch.cuda.synchronize()
    log("kernel pairwise_sq_l2 / topk_l2 / lpgf_force with NaN rows: ok="
        + str(ok) + " " + json.dumps(nan_info))
    if not ok:
        return fail("pairwise_sq_l2 / topk_l2 / lpgf_force with NaN rows "
                    "disagree with their plain versions")
    torch.cuda.empty_cache()

    # ---------------------------------------------------- fp32 path
    starts.append(("fp32 path", time.time()))
    torch.cuda.reset_peak_memory_stats()
    _reset(kmods)
    p, batch, res, stats, times = drive_main_path(args, dev)
    t_prep, radius, t_warm, t_exec = times
    big = large_k_batch(Q, np, p.table.vector["v"], args.seed + 2)
    t0 = time.time()
    big_res, big_stats = p.session().plan(big).execute()
    torch.cuda.synchronize()
    t_big = time.time() - t0
    fp32_launches = _counters(kmods)
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
    log(f"peak device memory on the fp32 path: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"k = 300 / 1000 batch (16 V.K, first run): {t_big:.3f} s, "
        f"knn_exact_fallbacks {big_stats.knn_exact_fallbacks}")
    log("launches on the fp32 path: " + json.dumps(fp32_launches))
    log("topk_l2 launches by route on the fp32 path: "
        + json.dumps(fused_topk.topk_l2_launches_by_route))
    path_launches = {n: fp32_launches[n] for n in
                     ("pairwise_sq_l2", "topk_l2", "topk_l2_masked")}
    if min(path_launches.values()) <= 0:
        return fail(f"a kernel of the fp32 path never launched: "
                    f"{fp32_launches}")

    t0 = time.time()
    bad, truths = oracle_mismatches(p, batch, res)
    sizes = [len(r) for r in res]
    log(f"oracle: {time.time() - t0:.1f} s, mismatches {len(bad)} of "
        f"{len(batch)}; rows per query min {min(sizes)} max {max(sizes)}")
    if bad:
        i = bad[0]
        return fail(f"query {i} differs from the oracle: got "
                    f"{res[i][:10]} want {truths[i][:10]}")
    if any(len(res[i]) != 20 for i in range(0, len(batch), 4)):
        return fail("a top-level V.K query returned fewer than k rows")
    bad_big, big_truths = oracle_mismatches(p, big, big_res)
    log(f"k = 300 / 1000 batch: mismatches {len(bad_big)} of {len(big)}")
    if bad_big or any(len(r) != q.k for r, q in zip(big_res, big)):
        i = bad_big[0] if bad_big else 0
        return fail(f"large-k query {i} (k={big[i].k}) differs from the "
                    f"oracle")
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

    # ----------------------------------------- mixed-precision path
    starts.append(("mixed-precision path", time.time()))
    _reset(kmods)
    mp_rows = {}
    # the (G, C) of every quant_lb2 launch on the path
    shapes = []
    launch = quant_lb2.quant_lb2_cuda

    def record(q, codes, *rest, precision):
        shapes.append((precision, codes.shape[0], codes.shape[1]))
        return launch(q, codes, *rest, precision=precision)
    quant_lb2.quant_lb2_cuda = record
    for prec in ("int8", "bf16"):
        sess = p.session(precision=prec)
        t0 = time.time()
        eng = sess.engine()
        torch.cuda.synchronize()
        t_eng = time.time() - t0
        got, st, tw, te = run_batch(args, dev, sess, batch)
        mp_rows[prec] = got
        bad = [i for i, (a, b, t) in enumerate(zip(got, res, truths))
               if not (np.array_equal(a, t) and np.array_equal(a, b))]
        ratio = st.mp_rescued / max(1, st.mp_scanned)
        proven = st.knn_jobs - st.knn_exact_fallbacks
        log(f"{prec}: engine build {t_eng:.1f} s, warm batch {tw:.2f} s, "
            f"timed batch {te:.3f} s, qps {args.batch / te:.1f}; "
            f"mp_scanned {st.mp_scanned} mp_rescued {st.mp_rescued} "
            f"rescue ratio {ratio:.4f}; V.K jobs {st.knn_jobs}, proven "
            f"without widening {proven}, knn_exact_fallbacks "
            f"{st.knn_exact_fallbacks}; plane device bytes "
            f"{eng.plane_bytes()}; rows equal to the oracle and to fp32: "
            f"{len(batch) - len(bad)} of {len(batch)}")
        if bad:
            return fail(f"{prec}: query {bad[0]} differs from the oracle "
                        f"or the fp32 rows")
        if st.mp_scanned <= 0:
            return fail(f"{prec}: the session scanned nothing in reduced "
                        f"precision")
        if proven <= 0:
            return fail(f"{prec}: no V.K job's re-rank was proven on the "
                        f"reduced-precision scan; every one widened")
    mp_launches = _counters(kmods)
    quant_lb2.quant_lb2_cuda = launch
    log("launches on the mixed-precision path: " + json.dumps(mp_launches))
    log("quant_lb2 launches on the path, (precision, G, C): "
        + json.dumps(shapes))
    if mp_launches["quant_lb2"] <= 0:
        return fail(f"quant_lb2 never launched on the mixed-precision "
                    f"path: {mp_launches}")

    # ------------------------------------------------- planner paths
    starts.append(("planner paths", time.time()))
    # on the same platform, after its timed batches: the scalar path, the
    # two executors, Algorithm 3 and the cost model's calibration
    t_planner = time.time()
    t0 = time.time()
    err, sc = drive_scalar_path(args, dev, p, radius, kmods)
    log(f"scalar path: {time.time() - t0:.1f} s; ms per query by form "
        f"(MQRLD.execute, record=False, 8 each, rows equal to the oracle): "
        + json.dumps(sc["ms_per_query"]))
    if "n_scalar" in sc:
        log(f"scalar path: planned batch of 64, n_scalar {sc['n_scalar']}: "
            f"{sc.get('planned_batch_s', float('nan')):.3f} s, mismatches "
            f"{sc.get('planned_batch_mismatches')}; launches "
            + json.dumps(sc.get("launches")))
    if err:
        return fail(err)
    t0 = time.time()
    err, ex_info, host = drive_executors(args, dev, p, kmods)
    log(f"executors: {time.time() - t0:.1f} s; 64 V.K at k = 20 over the "
        f"enhanced features: " + json.dumps(ex_info))
    if err:
        return fail(err)
    t0 = time.time()
    err, re_info = drive_reorder(args, p, host)
    log(f"reorder: {time.time() - t0:.1f} s; " + json.dumps(re_info))
    if err:
        return fail(err)
    del host
    t0 = time.time()
    err, cal = drive_calibration(args, dev, p, batch, truths, t_exec, kmods)
    log(f"calibrate: {time.time() - t0:.1f} s in all; calibrate() "
        f"{cal['calibrate_s']:.1f} s, by loop (s): "
        + json.dumps(cal["sweep_s"]) + f", host loop's share "
        f"{cal['sweep_s']['host'] / max(1e-9, sum(cal['sweep_s'].values())):.3f}")
    for kind, ent in cal["kinds"].items():
        log(f"  cost model {kind}: " + json.dumps(ent))
    log(f"calibrated session: timed batch {cal.get('batch_s', float('nan')):.3f}"
        f" s, qps {cal.get('qps', float('nan')):.1f} (uncalibrated "
        f"{cal.get('uncalibrated_qps', float('nan')):.1f}); device_loop "
        f"{cal.get('device_loop')}; choices " + json.dumps(cal.get("choices"))
        + "; V.R routes " + json.dumps(cal.get("vr_routes"))
        + f"; mismatches {cal.get('mismatches')}; calibration launches "
        + json.dumps(cal["launches"]))
    if err:
        return fail(err)
    log(f"planner paths: {time.time() - t_planner:.1f} s")

    # --------------------------------------------------- ingest path
    starts.append(("ingest path", time.time()))
    err, ing = drive_ingest_path(args, dev, p, batch, kmods)
    for j, a in enumerate(ing["appends"]):
        log(f"ingest: append {j + 1} of {INGEST_ROWS} rows: append "
            f"{a['append_ms']:.1f} ms, sync_delta {a['sync_ms']:.1f} ms; "
            f"{a['rows']} live rows in a capacity of {a['capacity']}; "
            f"delta_tiles {a['delta_tiles']} (device layout "
            f"{a['delta_tiles_device_layout']}); widths {a['widths']}")
    for c in ing["checks"]:
        log(f"ingest: {c['run']}: first batch {c['first_s']:.3f} s, then "
            f"median of 3 {c['batch_s']:.3f} s, qps {c['qps']:.1f}; oracle "
            f"{c['oracle_s']:.1f} s over {c['checked']} queries, mismatches "
            f"{c['mismatches']}")
    log("ingest: " + json.dumps({k: v for k, v in ing.items()
                                 if k not in ("appends", "checks")}))
    if err:
        return fail(err)
    if min(ing["launches"][n] for n in ("pairwise_sq_l2", "topk_l2_masked",
                                        "quant_lb2")) <= 0:
        return fail(f"a kernel of the ingest path never launched: "
                    f"{ing['launches']}")

    # ---------------------------------------------- persistence path
    starts.append(("persistence path", time.time()))
    t0 = time.time()
    kept_h = {}
    err, per, p2 = drive_persist_path(args, dev, p, batch, kmods, kept_h)
    log(f"persistence: {time.time() - t0:.1f} s; save {per.get('save_s', 0):.1f}"
        f" s, load {per.get('load_s', 0):.1f} s, "
        f"{per.get('bytes', {}).get('total', 0)} bytes on disk; loaded int8 "
        f"engine {per.get('int8_engine_s', float('nan')):.2f} s (with the "
        f"sync_delta of {PERSIST_ROWS} rows; (g)'s re-quantizing int8 "
        f"rebuild, without a delta: "
        f"{ing.get('rebuild_int8_s', float('nan')):.2f} s) "
        + json.dumps(per))
    if err:
        return fail(err)
    if min(per["launches"][n] for n in ("pairwise_sq_l2", "topk_l2_masked",
                                        "quant_lb2")) <= 0:
        return fail(f"a kernel of the persistence path never launched: "
                    f"{per['launches']}")

    # ------------------------------------------------- sharded path
    starts.append(("sharded path", time.time()))
    t0 = time.time()
    err, sh = drive_sharded_path(args, dev, p, batch, radius,
                                 kept_h["live"], kept_h["truths"], kmods)
    for run in sh["runs"]:
        log(f"sharded: S={run['shards']} {run['precision']}, "
            f"{run['queries']} queries ({card}): engine build "
            f"{run['engine_s']:.2f} s, warm batch {run['warm_s']:.2f} s, "
            f"timed batch {run['batch_s']:.3f} s, qps {run['qps']:.1f}; "
            + json.dumps({k: v for k, v in run.items() if k not in (
                "shards", "precision", "queries", "engine_s", "warm_s",
                "batch_s", "qps")}))
    log(f"sharded: {time.time() - t0:.1f} s; {card}; " + json.dumps(
        {k: v for k, v in sh.items() if k != "runs"}))
    if err:
        return fail(err)
    if min(sh["launches"][n] for n in ("pairwise_sq_l2", "topk_l2_masked",
                                       "quant_lb2")) <= 0:
        return fail(f"a kernel of the sharded path never launched: "
                    f"{sh['launches']}")
    del kept_h, sh
    # (h)'s live platform p stays for path (j); its engines go
    p._engines.clear()
    p._sessions.clear()
    del batch, res, truths, mp_rows, sess, eng
    gc.collect()
    torch.cuda.empty_cache()

    # -------------------------------------------------- serving path
    starts.append(("serving path", time.time()))
    t0 = time.time()
    keep = {}
    err, srv_info = drive_serving_path(args, dev, p2, kmods, keep)
    log(f"serving: {time.time() - t0:.1f} s; " + json.dumps(
        {k: v for k, v in srv_info.items() if k != "depth3_trace"}))
    if "depth3_trace" in srv_info:
        log("serving: int8 depth 3 traced (torch.profiler): "
            + json.dumps(srv_info["depth3_trace"]))
    if err:
        return fail(err)
    if min(srv_info["launches"][n] for n in (
            "pairwise_sq_l2", "topk_l2_masked", "quant_lb2")) <= 0:
        return fail(f"a kernel of the serving path never launched: "
                    f"{srv_info['launches']}")

    del p2
    gc.collect()            # the platform's reference cycles hold GiBs
    torch.cuda.empty_cache()

    # ------------------------------------------ re-optimization path
    starts.append(("re-optimization path", time.time()))
    t0 = time.time()
    err, ro = drive_reopt_path(args, dev, p, keep, kmods)
    log(f"reopt: {time.time() - t0:.1f} s on {ro.get('n_base')} + "
        f"{ro.get('n_delta')} rows (the background fold's input)")
    kinds = {}
    for kind, sec in ro["steps"]:
        kinds.setdefault(kind, []).append(sec)
    log("reopt: seconds by step kind: " + json.dumps(
        {k: dict(n=len(v), total_s=sum(v), max_s=max(v))
         for k, v in kinds.items()}))
    log("reopt: steps in order: " + json.dumps(ro["steps"]))
    log("reopt: " + json.dumps({k: v for k, v in ro.items()
                                if k not in ("steps", "polls")}))
    if ro["polls"]:
        log(f"reopt: {len(ro['polls'])} polls of {REOPT_CHUNK} requests, "
            f"longest {max(ro['polls']):.3f} s, median "
            f"{float(np.median(ro['polls'])):.4f} s")
    if err:
        return fail(err)
    if min(ro["launches"][n] for n in ("pairwise_sq_l2", "topk_l2",
                                       "lpgf_force", "topk_l2_masked")) <= 0:
        return fail(f"a kernel of the re-optimization path never launched: "
                    f"{ro['launches']}")
    del p, keep
    gc.collect()
    torch.cuda.empty_cache()
    # quant_lb2 again at the widest round each precision gave it
    for prec in ("int8", "bf16"):
        _, g, c = max((s for s in shapes if s[0] == prec),
                      key=lambda s: s[1] * s[2])
        ok, row = check_quant_lb2(torch, quant_lb2, ref, build, plan_tiles,
                                  dev, gen, args.dim, prec, g, c)
        torch.cuda.synchronize()
        log_kernel(f"quant_lb2 {prec} at the path's widest round", ok, row)
        if not ok:
            return fail(f"kernel quant_lb2 {prec} disagrees with its plain "
                        f"version at ({g}, {c}, {args.dim})")
        if prec == "int8":   # the JSON row is the int8 scan's
            kernels.insert(3, row)
        torch.cuda.empty_cache()

    # -------------------------------------------- small-table path
    starts.append(("small-table path", time.time()))
    _reset(kmods)
    sp, s_radius, s_prep = build_platform(args, dev, args.small_rows)
    sbatch = hybrid_batch(Q, np, sp.table.vector["v"], s_radius, 64,
                          args.seed + 3)
    sres, sst, s_warm, s_exec = run_batch(args, dev, sp.session(), sbatch)
    small_launches = _counters(kmods)
    bad, _ = oracle_mismatches(sp, sbatch, sres)
    log(f"small table: prepare {s_prep:.2f} s {sp.report}; radius "
        f"{s_radius}; warm batch {s_warm:.2f} s, timed batch {s_exec:.3f} "
        f"s; mismatches {len(bad)} of {len(sbatch)}")
    log("launches on the small-table path: " + json.dumps(small_launches))
    if bad:
        return fail(f"small table: query {bad[0]} differs from the oracle")
    if small_launches["lpgf_force"] <= 0:
        return fail(f"lpgf_force never launched on the small-table path: "
                    f"{small_launches}")
    err, rb = drive_rollback(args, dev, sp, sbatch)
    log("generations and rollback on the small table: " + json.dumps(rb))
    if err:
        return fail(err)

    del sp, sbatch, sres
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------ embedding path
    starts.append(("embedding path", time.time()))
    _reset(kmods)
    ok, emb = drive_embedding_path(args, dev)
    emb_launches = _counters(kmods)
    torch.cuda.empty_cache()
    log("embedding path (mqrld-embedder-100m, 64 x 128 tokens): "
        + json.dumps(emb))
    log("launches on the embedding path (dense attention, no TPU kernel): "
        + json.dumps(emb_launches))
    if not ok:
        return fail(f"embedding path: {emb}")

    # ----------------------------------------------- generation path
    starts.append(("generation path", time.time()))
    _reset(kmods)
    ok, gen_info = drive_generation_path(args, dev, flash_attention, ref)
    gen_launches = _counters(kmods)
    gc.collect()
    torch.cuda.empty_cache()
    log("generation path (llama3-8b, 32 layers, prompts 2048, 2048, 1000, "
        "1000, max_new 16): " + json.dumps(gen_info))
    for b in gen_info["buckets"]:
        log(f"  bucket of {b['batch']} x {b['prompt']} tokens: prefill "
            f"{b['prefill_s']:.3f} s, decode {b['decode_ms_per_token']:.2f} "
            f"ms per token")
    for name in ("prefill_trace", "decode_trace"):
        log(f"  {name} (torch.profiler): " + json.dumps(gen_info[name]))
    log(f"  init {gen_info['init_s']:.1f} s, peak device memory "
        f"{gen_info['peak_gib']:.2f} GiB (weights "
        f"{gen_info['weights_gib']:.2f} GiB)")
    log("launches on the generation path: " + json.dumps(gen_launches))
    if not ok:
        return fail(f"generation path: {gen_info}")
    if gen_launches["flash_attention_wgmma"] <= 0 or \
            gen_launches["flash_attention"] != 0:
        return fail(f"the generation path's flash launches did not all take "
                    f"the wgmma kernel: {gen_launches}")

    # ------------------------------------------ fp32 generation path
    starts.append(("fp32 generation path", time.time()))
    _reset(kmods)
    ok, f32_info = drive_fp32_generation_path(args, dev, flash_attention,
                                              ref)
    f32_launches = _counters(kmods)
    torch.cuda.empty_cache()
    log("fp32 generation path (reduced llama3-8b, prompts 1000, 1000, 300, "
        "40): " + json.dumps(f32_info))
    log("launches on the fp32 generation path: " + json.dumps(f32_launches))
    if not ok:
        return fail(f"fp32 generation path: {f32_info}")
    if f32_launches["flash_attention"] <= 0 or \
            f32_launches["flash_attention_wgmma"] != 0:
        return fail(f"the fp32 generation path's flash launches did not all "
                    f"take the SIMT kernel: {f32_launches}")

    # ------------------------------------ olmo-1b fp32 serving path
    starts.append(("olmo-1b fp32 serving path", time.time()))
    _reset(kmods)
    ok, olmo = drive_olmo_fp32_path(args, dev, flash_attention, ref)
    olmo_launches = _counters(kmods)
    torch.cuda.empty_cache()
    log(f"olmo-1b fp32 serving path ({OLMO_LAYERS} of 16 layers, prompts "
        "2032, 2032, 1000, "
        "1000, max_new 16): " + json.dumps(olmo))
    for b in olmo["buckets"]:
        log(f"  bucket of {b['batch']} x {b['prompt']} tokens: prefill "
            f"{b['prefill_s']:.3f} s, decode {b['decode_ms_per_token']:.2f} "
            f"ms per token")
    log("  prefill_trace (torch.profiler): "
        + json.dumps(olmo["prefill_trace"]))
    fx = olmo["vs_fp64"]
    log(f"  init {olmo['init_s']:.1f} s, peak device memory "
        f"{olmo['peak_gib']:.2f} GiB (weights {olmo['weights_gib']:.2f} "
        f"GiB); SIMT launches {olmo['flash_simt_launches']} of "
        f"{olmo['flash_checked_launches']} checked, worst error "
        f"{olmo['flash_max_abs_err']:.3g} against the plain version; "
        f"against the exact (fp64) result the kernel "
        f"{fx['max_abs_err']['kernel']:.3g}, the plain version "
        f"{fx['max_abs_err']['plain']:.3g}, it with hd shuffled "
        f"{fx['max_abs_err']['reordered']:.3g} (each launch's largest "
        f"error held to {fx['max_rule']:.3g}); worst launch's ratio to "
        f"the plain version, largest error: kernel "
        f"{fx['worst_launch_ratio_max']['kernel']:.3f}, reordered "
        f"{fx['worst_launch_ratio_max']['reordered']:.3f} (over "
        f"{FP64_RATIO} in {fx['launches_over_ratio_max']['kernel']} and "
        f"{fx['launches_over_ratio_max']['reordered']} launches); root mean "
        f"square (held to {FP64_RATIO}): kernel "
        f"{fx['worst_launch_ratio_rms']['kernel']:.3f}, reordered "
        f"{fx['worst_launch_ratio_rms']['reordered']:.3f}; "
        f"{fx['launches_within_2e_5_of_plain']} launches within "
        f"2e-5 + 2e-5|b| of the plain version; the plain version "
        f"reordered against itself: largest difference "
        f"{fx['max_abs_err']['reordered_vs_plain']:.3g}")
    log("launches on the olmo-1b fp32 serving path: "
        + json.dumps(olmo_launches))
    if not ok:
        return fail(f"olmo-1b fp32 serving path: {olmo}")
    olmo_want = 2 * OLMO_LAYERS       # both buckets' prefills, every layer
    if olmo["flash_checked_launches"] != olmo_want or \
            olmo_launches["flash_attention_wgmma"] != 0:
        return fail(f"the olmo-1b fp32 path's prefills did not make "
                    f"{olmo_want} checked launches, all on the SIMT kernel: "
                    f"{olmo_launches}")

    # ------------------------------------------------ (k) MoE paths
    moe_runs = {}
    for name, layers, prompts, max_new in MOE_RUNS:
        starts.append((f"MoE path ({name})", time.time()))
        _reset(kmods)
        ok, mi = drive_moe_path(args, dev, flash_attention, ref, name,
                                layers, prompts, max_new)
        ml = _counters(kmods)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"MoE path ({name}, {mi['layers']} layers, prompts "
            f"{', '.join(map(str, prompts))}, max_new {max_new}): "
            + json.dumps({k: v for k, v in mi.items()
                          if k not in ("prefill_trace", "routing")}))
        log(f"  routing of the {mi['routing']['tokens']} prefill: "
            + json.dumps(mi["routing"]))
        for b in mi["buckets"]:
            log(f"  bucket of {b['batch']} x {b['prompt']} tokens: prefill "
                f"{b['prefill_s']:.3f} s, decode "
                f"{b['decode_ms_per_token']:.2f} ms per token")
        log("  prefill_trace (torch.profiler): "
            + json.dumps(mi["prefill_trace"]))
        log(f"  init {mi['init_s']:.1f} s (peak {mi['init_peak_gib']:.2f} "
            f"GiB), peak device memory {mi['peak_gib']:.2f} GiB (weights "
            f"{mi['weights_gib']:.2f} GiB, {mi['n_params']} parameters), "
            f"resident before {mi['resident_gib_before']:.2f} GiB")
        log(f"launches on the MoE path ({name}): " + json.dumps(ml))
        if not ok:
            return fail(f"MoE path ({name}): {mi['checks']}")
        if ml["flash_attention_wgmma"] <= 0 or ml["flash_attention"] != 0:
            return fail(f"the MoE path's ({name}) flash launches did not "
                        f"all take the wgmma kernel: {ml}")
        moe_runs[name] = (mi, ml)

    # ---------------------------------------------- (l) hymba path
    starts.append(("hymba path", time.time()))
    _reset(kmods)
    ok, hy = drive_hymba_path(args, dev, flash_attention, ref)
    hy_launches = _counters(kmods)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"hymba path (hymba-1.5b, 32 layers, 2 prompts of {HYMBA_PROMPT}, "
        f"max_new 16): " + json.dumps(
            {k: v for k, v in hy.items() if k != "decode_trace"},
            default=str))
    log(f"  init {hy['init_s']:.1f} s, stream forward (with the flash "
        f"checks) {hy['stream_forward_s_with_checks']:.2f} s, replay "
        f"{hy['replay_s']:.1f} s ({hy['replay_s_per_step'] * 1e3:.2f} ms "
        f"per step of 2 rows), decode {hy['decode_ms_per_token']:.2f} ms "
        f"per token, peak device memory {hy['peak_gib']:.2f} GiB (weights "
        f"{hy['weights_gib']:.2f} GiB), resident before "
        f"{hy['resident_gib_before']:.2f} GiB")
    log("  decode_trace (torch.profiler, one step): "
        + json.dumps(hy["decode_trace"]))
    log("launches on the hymba path: " + json.dumps(hy_launches))
    if not ok:
        return fail(f"hymba path: {hy['checks']}")
    if hy_launches["flash_attention_wgmma"] != 32 or \
            hy_launches["flash_attention"] != 0:
        return fail(f"the hymba path's stream forward did not make 32 "
                    f"launches, all on the wgmma kernel: {hy_launches}")

    # ---------------------------------------------- (m) xlstm path
    starts.append(("xlstm path", time.time()))
    _reset(kmods)
    ok, xl = drive_xlstm_path(args, dev)
    xl_launches = _counters(kmods)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"xlstm path (xlstm-1.3b, 48 blocks, prompts "
        f"{', '.join(map(str, XLSTM_PROMPTS))}, max_new 16): " + json.dumps(
            {k: v for k, v in xl.items() if k != "prefill_trace"},
            default=str))
    for b in xl["buckets"]:
        log(f"  bucket of {b['batch']} x {b['prompt']} tokens: prefill "
            f"{b['prefill_s']:.3f} s, decode "
            f"{b['decode_ms_per_token']:.2f} ms per token")
    log(f"  init {xl['init_s']:.1f} s, state {xl['state_mib_batch_2']:.1f} "
        f"MiB for 2 rows, sLSTM scans {xl['slstm']['share']:.1%} of a "
        f"{xl['slstm']['prefill_s_synchronized']:.3f} s prefill "
        f"({xl['slstm']['ms_per_step'] * 1e3:.1f} us a step), peak device "
        f"memory {xl['peak_gib']:.2f} GiB (weights {xl['weights_gib']:.2f} "
        f"GiB, {xl['n_params']} parameters), resident before "
        f"{xl['resident_gib_before']:.2f} GiB")
    log("  prefill_trace (torch.profiler): "
        + json.dumps(xl["prefill_trace"]))
    log("launches on the xlstm path (no TPU kernel covers it): "
        + json.dumps(xl_launches))
    if not ok:
        return fail(f"xlstm path: {xl['checks']}")

    # ---------------------------------------------- (n) enc-dec path
    starts.append(("enc-dec path", time.time()))
    _reset(kmods)
    ok, ed = drive_encdec_path(args, dev, flash_attention, ref)
    ed_launches = _counters(kmods)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"enc-dec path (seamless-m4t-medium, 12 + 12 layers, prompts "
        f"{', '.join(map(str, ENCDEC_PROMPTS))}, max_new 16, zero "
        f"frames): " + json.dumps(
            {k: v for k, v in ed.items()
             if k not in ("prefill_trace", "decode_trace")},
            default=str))
    for b in ed["buckets"]:
        log(f"  bucket of {b['batch']} x {b['prompt']} tokens: prefill "
            f"(stream forward, cross cache, replay) {b['prefill_s']:.3f} "
            f"s, decode {b['decode_ms_per_token']:.2f} ms per token")
    log(f"  init {ed['init_s']:.1f} s, encoder at 4,096 frames "
        f"{ed['encode_s']:.3f} s, Gaussian-frame prefill (stream forward "
        f"+ cross cache) {ed['prefill_s_gaussian']:.3f} s, replay "
        f"{ed['replay_ms_per_step']:.2f} ms per step of 2 rows, decode "
        f"{ed['decode_ms_per_token_gaussian']:.2f} ms per token, peak "
        f"device memory {ed['peak_gib']:.2f} GiB (weights "
        f"{ed['weights_gib']:.2f} GiB, {ed['n_params']} parameters)")
    log("  prefill_trace (torch.profiler): "
        + json.dumps(ed["prefill_trace"]))
    log("  decode_trace (torch.profiler, one step): "
        + json.dumps(ed["decode_trace"]))
    log("launches on the enc-dec path: " + json.dumps(ed_launches))
    if not ok:
        return fail(f"enc-dec path: {ed['checks']}")
    if ed_launches["flash_attention_wgmma"] <= 0 or \
            ed_launches["flash_attention"] != 0:
        return fail(f"the enc-dec path's stream forwards did not all take "
                    f"the wgmma kernel: {ed_launches}")

    # ------------------------------------------------ (p) training path
    starts.append(("training path", time.time()))
    _reset(kmods)
    err, tr = drive_train_path(args, dev)
    tr_launches = _counters(kmods)
    gc.collect()
    torch.cuda.empty_cache()
    num = tr.get("numerics", {})
    log(f"training path ({TRAIN_ARCH}, {tr.get('n_params')} parameters, "
        f"{TRAIN_STEPS} steps of {8 * TRAIN_MB} x {TRAIN_SEQ} tokens in "
        f"{TRAIN_MB} microbatches, bf16 compute, fp32 masters, remat "
        f"block; {card}): " + json.dumps(
            {k: v for k, v in tr.items()
             if k not in ("numerics", "log", "step_s_all", "losses",
                          "step_trace")}))
    if "step_s" in tr:
        log(f"  step {tr['step_s']:.4f} s (median after the first, "
            f"{tr['first_step_s']:.2f} s), {tr['tokens_per_s']:.0f} "
            f"tokens/s, MFU {tr['mfu']:.4f} of the bf16 peak, peak device "
            f"memory {tr['peak_gib']:.2f} GiB, loss {tr['loss_first']:.4f} "
            f"-> {tr['loss_last']:.4f}; steps (s): "
            + json.dumps(tr["step_s_all"]))
    if "step_trace" in tr:
        log("  step_trace (torch.profiler, one step after training): "
            + json.dumps(tr["step_trace"]))
    log("  numerics (fp32 and bf16 gradients against fp64, leaf RMS "
        "error over leaf RMS; AdamW on the card against the CPU): "
        + json.dumps({k: v for k, v in num.items()
                      if k not in ("leaves", "tempered_leaves")}))
    for k, v in num.get("leaves", {}).items():
        log(f"    {k}: " + json.dumps(v) + "; q, k tempered: "
            + json.dumps(num["tempered_leaves"].get(k)))
    for line in tr.get("log", []):
        log(f"  {line}")
    log("launches on the training path: " + json.dumps(tr_launches))
    if err:
        return fail(f"training path: {err}")
    if min(tr_launches[n] for n in ("pairwise_sq_l2",
                                    "topk_l2_masked")) <= 0:
        return fail(f"a kernel of the training path's platform never "
                    f"launched: {tr_launches}")

    # ------------------------------------- (q) the families trained
    rc = run_family_train_path(args, dev, kmods, card, starts)
    if rc:
        return rc

    # ------------------- (b) build options and (r) the dry run held
    rc = run_dryrun_paths(args, dev, kmods, flash_attention, ref, card,
                          starts)
    if rc:
        return rc

    # ------------------------------------------------- (s) the examples
    rc = run_examples_path(args, dev, kmods, card, starts)
    if rc:
        return rc

    starts.append(("flash_attention checks", time.time()))
    # flash_attention at each kernel's widest path launch: the two
    # kernels' rows (wgmma: llama3-8b's prefill; SIMT: olmo-1b's fp32
    # prefill). Then the fp32 path (e)'s shape, at the llama prefill's
    # shape the SIMT kernel on the same bf16 inputs (launched by name) and
    # in fp32, and the further cases; bf16 at hd 64 and 128 on both kernels
    shape, dtype = gen_info["flash_shape"]
    olmo_shape = olmo["flash_shape"][0]
    f32_shape = f32_info["flash_shape"][0]
    dtype = dtype.replace("torch.", "")
    cases = [(shape, dtype, True, 0, "normal", None),
             (olmo_shape, "float32", True, 0, "normal", None),
             (f32_shape, "float32", True, 0, "normal", None),
             (shape, dtype, True, 0, "normal", "simt"),
             (shape, "float32", True, 0, "normal", None)]
    # the new paths' widest launches: arctic's 64 padded heads, hymba's
    # windowed and global layers at hd 64
    arctic_shape = moe_runs["arctic-480b"][0]["flash_shape"][0]
    hymba_shape = hy["flash_shape"][0]
    cases += [(arctic_shape, dtype, True, 0, "normal", None),
              (hymba_shape, dtype, True, hy["window"], "normal", None),
              (hymba_shape, dtype, True, 0, "normal", None)]
    # (n)'s widest launch: seamless-m4t-medium's 16 heads of hd 64
    cases.append((ed["flash_shape"][0], dtype, True, 0, "normal", None))
    path_rows = {5: ("k", moe_runs["arctic-480b"][1]),
                 6: ("l", hy_launches), 7: ("l", hy_launches),
                 8: ("n", ed_launches)}
    for shp, dt, causal, window, inputs in FLASH_CASES:
        cases.append((shp, dt, causal, window, inputs, None))
        if flash_attention.route(getattr(torch, dt), shp[3]) == "wgmma":
            cases.append((shp, dt, causal, window, inputs, "simt"))
    labels = (" on the generation path's shape",
              " on the olmo-1b fp32 path's shape",
              " on the fp32 generation path's shape",
              " at the prefill's shape", " at the prefill's shape",
              " on the MoE path's arctic shape",
              " on the hymba path's windowed layers",
              " on the hymba path's global layers",
              " on the enc-dec path's decoder")
    for i, (shp, dt, causal, window, inputs, kern) in enumerate(cases):
        ok, row = check_flash(torch, flash_attention, ref, dev, gen, shp, dt,
                              causal, window, inputs, kern,
                              sdpa_backend=i < 3 or i in path_rows)
        torch.cuda.synchronize()
        log_kernel(row["name"] + (labels[i] if i < len(labels) else ""),
                   ok, row)
        before = SIMT_BEFORE_MS.get(tuple(shp)) if i in (1, 2) else None
        if before is not None:
            log(f"kernel {row['name']} at {tuple(shp)} float32 causal: "
                f"{row['ms']:.4f} ms; the SIMT kernel before its Hopper "
                f"redesign (64-query blocks, synchronous staging): "
                f"{' and '.join(map(str, before))} ms "
                f"({SIMT_BEFORE_SOURCE}); bound {row['bound_ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, "
                f"scaled_dot_product_attention {row['library_ms']:.4f} ms")
        if not ok:
            return fail(f"kernel {row['name']} disagrees with its plain "
                        f"version at {row['shape']}")
        if i < 2:       # each kernel's row, at its own path's shape
            kernels.append(row)
        if i in path_rows:  # the new paths' shapes, with their launches
            row["path"] = path_rows[i][0]
            row["launches"] = path_rows[i][1][row["name"]]
            kernels.append(row)
        torch.cuda.empty_cache()

    launches = {**path_launches, "quant_lb2": mp_launches["quant_lb2"],
                "lpgf_force": small_launches["lpgf_force"],
                "flash_attention_wgmma": gen_launches["flash_attention_wgmma"],
                "flash_attention": olmo_launches["flash_attention"]}
    for row in kernels:
        if "path" not in row:
            row["launches"] = launches[row["name"]]
    starts.append(("end", time.time()))
    log("seconds by section: " + json.dumps(
        {a[0]: round(b[1] - a[1], 1) for a, b in zip(starts, starts[1:])}))
    log(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")
         + (("path", "shape") if "path" in row else ())}
        for row in kernels]}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
