"""The highest rate a served cell sustains, found once by a sweep on the
card: the cell set up once, then its open loop at each rate in turn.

    python3 perfbench/sweep.py --workload <cell> --seed <n> \\
        --seconds <s> --rates 100 150 200 ...

One JSON line per rate: requests due, resolved within the seconds, p50
and p95 latency, and the backlog left. A cell's ``rate`` goes below the
highest rate whose backlog stays flat: at about four fifths of it, or
lower where repeated runs at that rate read p95s that part (one host
loop admits and serves every request, so near capacity the tail swings
with the host's speed). Its ``why`` states the rate and its share of
the swept capacity."""
import os
import sys


def main(argv=None) -> int:
    import argparse

    import torch

    from perfbench import spec
    from perfbench.harness import Ctx
    from perfbench.record import Recorder
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load(a.workload)
    kind = spec.load_module("traffic", cell.workload["kind"], cell.dirs)
    ctx = Ctx(cell, a.seed, a.seconds, a.device, Recorder())
    kind.sweep(ctx, kind.setup(ctx), a.rates, a.seconds)
    return 0


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    sys.exit(main())
