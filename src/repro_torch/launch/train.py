"""Training launcher CLI (port of ``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --steps 100 --seq-len 256 --reduced --ckpt /tmp/ckpt

Runs on the CUDA card unless ``--device cpu`` is given (without a card
and without that flag it raises). The data pipeline is a pure function of
(seed, step, host), and a run resumes from the latest checkpoint in
``--ckpt``. Every decoder family trains here (``--arch hymba-1.5b``,
``--arch xlstm-1.3b``, ...); an enc-dec arch raises, since ``train()``
feeds tokens only and its model needs frames (train it through
``make_train_step`` on ``Model.make_batch``'s batches).
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mqrld-embedder-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--state-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8"])
    ap.add_argument("--ckpt", default="/tmp/repro_train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--reduced", action="store_true",
                    help="width-reduced config (CPU-friendly)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.train.loop import train

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainConfig(total_steps=args.steps, learning_rate=args.lr,
                     warmup_steps=max(1, args.steps // 20),
                     microbatches=args.microbatches,
                     checkpoint_every=args.ckpt_every,
                     checkpoint_dir=args.ckpt, seed=args.seed)
    res = train(cfg, tc, seq_len=args.seq_len,
                state_dtype=args.state_dtype, device=args.device)
    print(f"done: {res.steps_run} steps, loss "
          f"{res.losses[0] if res.losses else float('nan'):.4f} -> "
          f"{res.final_loss:.4f}, skipped {res.skipped_steps}")
    return res


if __name__ == "__main__":
    main()
