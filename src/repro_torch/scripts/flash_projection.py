"""Flash-kernel memory projection over the dry run.

The dry run's train steps run attention's differentiable dense path,
which streams (S, S) score tensors through HBM; the flash kernel keeps
its score tiles on chip. This script traces one dry-run cell
(``repro_torch.launch.dryrun``) with a counter that also tallies
"score-class" bytes — the bytes of every operation one of whose tensors
has two equal dims >= 2048, the reference's ``score_class`` rule (only
attention scores have that shape in these models) — and reports the
memory term and roofline fraction with those bytes taken out, as if the
flash kernel held the scores.

    PYTHONPATH=src python -m repro_torch.scripts.flash_projection \\
        olmo-1b train_4k [--opt]

The trace runs on fake CPU tensors (the dry run's), so nothing is placed
on any device.
"""
import argparse
import re
from typing import Optional, Sequence

from repro_torch.configs import SHAPES_BY_NAME, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils import opcount
from repro_torch.utils.roofline import HBM_BW

SCORE_DIM = 2048


def score_shape(dims: Sequence[int]) -> bool:
    """True when a shape has two equal dims >= 2048 (S x S scores)."""
    big = [int(d) for d in dims if int(d) >= SCORE_DIM]
    return len(big) >= 2 and len(set(big)) < len(big)


def score_class(type_str: str) -> bool:
    """The reference's predicate on an HLO type string (``f32[2,8,2048,
    2048]{...}``, tuples included): any shape in it a score shape."""
    for m in re.finditer(r"\w+\[([\d,]+)\]", type_str):
        if score_shape([int(x) for x in m.group(1).split(",") if x]):
            return True
    return False


class ScoreCounter(opcount.Counter):
    """``opcount.Counter`` that also sums, in ``score_bytes``, the bytes
    it charges to each operation with a score-shaped input or output
    (weighted by the same loop trips)."""

    def __init__(self, fake: bool = True):
        super().__init__(fake)
        self.score_bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.stats.hbm_bytes
        out = super().__torch_dispatch__(func, types, args, kwargs)
        moved = self.stats.hbm_bytes - before
        if moved and any(score_shape(t.shape) for t in
                         opcount._tensors((args, kwargs or {}, out))):
            self.score_bytes += moved
        return out


def project(arch: str, shape, opt: bool = False, *, cfg=None,
            mesh=None) -> dict:
    """One cell's dry run (``shape``: a name or a ``ShapeConfig``; ``cfg``
    and ``mesh`` default to the registered config and the single-pod
    production mesh) and its flash projection."""
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    cfg = cfg if cfg is not None else get_config(arch)
    mesh = mesh if mesh is not None else make_production_mesh()
    made = []

    def counter(fake):
        made.append(ScoreCounter(fake))
        return made[-1]

    res = dr.dry_run(cfg, shape, mesh, dr.overrides(arch, shape.kind, opt),
                     arch=arch, counter_cls=counter)
    rl = res["roofline"]
    total = rl["bytes_per_dev"]
    sb = made[0].score_bytes / res["n_devices"]
    t_mem_flash = max(total - sb, 0.0) / HBM_BW
    terms = {"compute": rl["t_compute"], "memory": t_mem_flash,
             "collective": rl["t_collective"]}
    frac = rl["t_compute"] / max(max(terms.values()), 1e-12)
    return dict(arch=arch, shape=shape.name, opt=opt, bytes_per_dev=total,
                score_bytes_per_dev=sb, t_memory=rl["t_memory"],
                t_memory_flash=t_mem_flash,
                roofline_fraction=rl["roofline_fraction"],
                roofline_fraction_flash=frac, dry_run=res)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("arch", nargs="?", default="olmo-1b")
    ap.add_argument("shape", nargs="?", default="train_4k")
    ap.add_argument("--opt", action="store_true",
                    help="the dry run's optimization overrides")
    args = ap.parse_args(argv)
    r = project(args.arch, args.shape, args.opt)
    total, sb = r["bytes_per_dev"], r["score_bytes_per_dev"]
    print(f"{r['arch']} x {r['shape']} ({'opt' if r['opt'] else 'baseline'}):")
    print(f"  memory bytes/dev: {total:.3e}  score-class: {sb:.3e} "
          f"({100*sb/max(total,1):.1f}%)")
    print(f"  t_memory: {r['t_memory']:.3f}s -> flash-projected "
          f"{r['t_memory_flash']:.3f}s")
    print(f"  roofline fraction: {r['roofline_fraction']:.4f} -> "
          f"projected {r['roofline_fraction_flash']:.4f}")
    return r


if __name__ == "__main__":
    main()
