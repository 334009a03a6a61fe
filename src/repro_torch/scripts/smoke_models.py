"""Quick dev smoke: every arch's reduced config, forward + loss gradient
+ prefill + one decode step, all finite.

    PYTHONPATH=src python -m repro_torch.scripts.smoke_models [--device cpu]

Exits non-zero when any config fails.
"""
import argparse
import sys
import traceback

import torch

from repro_torch import resolve_device
from repro_torch.configs import ShapeConfig, all_configs
from repro_torch.models import build_model
from repro_torch.train.optimizer import global_norm
from repro_torch.train.step import loss_and_grads

SMALL_TRAIN = ShapeConfig("t", 32, 2, "train")
SMALL_DECODE = ShapeConfig("d", 32, 2, "decode")
SMALL_PREFILL = ShapeConfig("p", 16, 2, "prefill")


def _finite(t: torch.Tensor) -> bool:
    return bool(torch.isfinite(t.float()).all())


def smoke(cfg, dev) -> dict:
    """One reduced config through loss, gradient, decode and prefill."""
    m = build_model(cfg, device=dev)
    masters = m.init_masters(0)
    batch = m.make_batch(SMALL_TRAIN, 0)
    loss, grads = loss_and_grads(m, masters, batch)
    gnorm = global_norm(grads)
    assert _finite(loss), f"{cfg.name} loss not finite"
    assert _finite(gnorm), f"{cfg.name} grad not finite"
    # decode one token
    params = m.init(0)
    cache = m.init_cache(SMALL_DECODE.global_batch, SMALL_DECODE.seq_len)
    tok = torch.zeros((SMALL_DECODE.global_batch, 1), dtype=torch.int32,
                      device=dev)
    lg, _ = m.decode(params, cache, tok)
    assert _finite(lg), f"{cfg.name} decode"
    # prefill
    pb = m.make_batch(SMALL_PREFILL, 0)
    lgp, _ = m.prefill(params, pb, SMALL_DECODE.seq_len)
    assert _finite(lgp), f"{cfg.name} prefill"
    return dict(loss=float(loss), gnorm=float(gnorm),
                n_params=m.n_params())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    results, ok = {}, True
    for name, cfg in sorted(all_configs().items()):
        try:
            r = smoke(cfg.reduced(), dev)
            results[name] = dict(ok=True, **r)
            print(f"OK   {name:28s} loss={r['loss']:.3f} "
                  f"gnorm={r['gnorm']:.3f} nparams={r['n_params']:,}")
        except Exception as e:  # noqa: BLE001
            ok = False
            results[name] = dict(ok=False, error=f"{type(e).__name__}: {e}")
            print(f"FAIL {name}: {e}")
            traceback.print_exc()
    return dict(ok=ok, configs=results)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
