"""End to end: train the ~100M-parameter embedding backbone for a
few hundred steps on synthetic text, then use it as the platform's
embedding model (the paper's "embedding model pool" entry).

    PYTHONPATH=src python -m repro_torch.examples.train_embedder \\
        [--steps 200] [--full] [--ckpt DIR] [--device cpu]

A width-reduced 100M-layout model by default; pass --full to train the
published mqrld-embedder-100m config (the card's size; slow on a CPU).
Training resumes from the latest checkpoint in --ckpt.
"""
import argparse
import dataclasses

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import TrainConfig, get_config
from repro_torch.core import query as Q
from repro_torch.core.lake import MMOTable
from repro_torch.core.measurement import measure_models, select_model
from repro_torch.core.platform import MQRLD
from repro_torch.serve.engine import EmbeddingServer
from repro_torch.train.loop import train

DOCS = 2000             # documents embedded into the platform
DOC_TOKENS = 64         # tokens a document


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt", default="/tmp/mqrld_embedder_ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("mqrld-embedder-100m")
    if not args.full:
        cfg = dataclasses.replace(cfg, num_layers=4, d_model=256,
                                  num_heads=8, num_kv_heads=8, d_ff=1024,
                                  vocab_size=4096, head_pad_multiple=1)
    tc = TrainConfig(total_steps=args.steps, learning_rate=3e-4,
                     warmup_steps=20, microbatches=1,
                     checkpoint_every=100, checkpoint_dir=args.ckpt)
    print(f"training {cfg.name}: {args.steps} steps "
          f"({'full 100M' if args.full else 'reduced layout'})")
    res = train(cfg, tc, seq_len=128, log_every=20, device=dev)
    first = res.losses[0] if res.losses else float("nan")
    print(f"loss {first:.3f} -> {res.final_loss:.3f} "
          f"({res.steps_run} steps, {res.skipped_steps} skipped)")
    out = dict(cfg=cfg, losses=res.losses, loss_first=first,
               loss_last=res.final_loss, steps_run=res.steps_run,
               skipped=res.skipped_steps, step_s=res.step_s)

    # ---- use the trained model as the platform's embedder
    # a fresh init here (the reference's example does the same); in
    # production you'd restore the checkpoint (see repro_torch.checkpoint)
    server = EmbeddingServer(cfg, seed=tc.seed, device=dev)
    rng = np.random.default_rng(0)
    docs = rng.integers(1, cfg.vocab_size // 2,
                        (DOCS, DOC_TOKENS)).astype(np.int32)
    docs[DOCS // 2:] += cfg.vocab_size // 3  # two topical groups
    emb = server.embed(docs)

    # measurement (paper §5.1.2): is this embedder better than noise?
    noise = rng.normal(size=emb.shape).astype(np.float32)
    scores = measure_models(emb.astype(np.float32),
                            {"trained": emb, "noise": noise}, k=4)
    best = select_model(scores, method="IN")
    by_model = {s.model: round(s.score('IN'), 3) for s in scores}
    print("measurement chose:", best.model, by_model)

    length = rng.uniform(50, 500, len(docs)).astype(np.float32)
    table = (MMOTable("docs")
             .add_vector("text", emb, model=cfg.name)
             .add_numeric("length", length))
    p = MQRLD(table, seed=0, device=dev)
    p.prepare(min_leaf=16, max_leaf=256)
    q = Q.And.of(Q.NR("length", 100, 400), Q.VK.of("text", emb[0], 10))
    rows, stats = p.execute(q)
    exact = set(rows.tolist()) == set(p.oracle(q).tolist())
    print(f"hybrid query over trained embeddings: {len(rows)} results, "
          f"CBR {stats.cbr:.3f}, exact={exact}")
    out.update(table=table, emb=emb, noise=noise, chose=best.model, scores=by_model,
               query=q, rows=rows, row_ids=p.view().row_ids, cbr=stats.cbr,
               exact=exact)
    return out


if __name__ == "__main__":
    main()
