"""Readings that set a cell's limits, at the cell's own size, without
its timed window:

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3 [--sound]

For each seed, the control's readings (the reference put in the
program's place and computed one precision below the configuration's;
each must fail a limit), and with ``--sound`` the program's readings of
the numbers that a traffic kind can read without a whole run. One JSON
line per seed and kind of reading."""
import json
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
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sound", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load(a.workload)
    kind = spec.load_module("traffic", cell.workload["kind"], cell.dirs)
    limits = cell.workload["limits"]
    for seed in a.seeds:
        ctx = Ctx(cell, seed, 0, a.device, Recorder())
        rows = [("control", kind.control(ctx))]
        if a.sound and hasattr(kind, "sound"):
            rows.append(("program", kind.sound(ctx)))
        for who, read in rows:
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "reading": who, "numbers": read,
                              "fails": sorted(k for k, v in read.items()
                                              if v > limits[k])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[:0] = [root, os.path.join(root, "src")]
    sys.exit(main())
