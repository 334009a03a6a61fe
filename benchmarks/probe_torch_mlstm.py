"""Where the chunked mLSTM's fp32 error comes from, on the card and on the
CPU (the port's ``repro_torch.models.xlstm.mlstm_parallel``).

xlstm-1.3b's first mLSTM block at full width (d_model 2048, 4 heads of
hd 512, chunk 64; weights drawn by the init law from ``--seed`` and held
in their serving types, bf16 matrices), on one fp32 input (2, 256, 2048)
drawn on the card. The same fp32 weights and input run:

  * on the card in fp32, with TF32 off;
  * on the CPU in fp32;
  * on the CPU in fp64: the exact result each is held to;
  * on the CPU in fp32 with the head dimension of q and k permuted
    (``--perms`` random permutations of the columns of wq and wk, the
    same one for both): every q.k product is the same sum taken in
    another order, so these runs show how far the error moves with the
    order of the reductions alone.

For each run it prints the RMS error against fp64 of every term of the
chunk body (``mlstm_parallel``'s ``terms``), over the RMS of the exact
term, and of the block's output; then the same for the step recurrence
(``mlstm_step``); and the output's error split into the elements whose
exact value lies within 10x the output's RMS and those beyond. One JSON
line per run, a last JSON line with all of them.

    PYTHONPATH=src python benchmarks/probe_torch_mlstm.py [--cpu-only]
"""
import argparse
import json
import sys
import time
from types import SimpleNamespace

import torch

from repro_torch.configs import get_config
from repro_torch.models import spec as S
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X


def _rms(t) -> float:
    return float(t.double().square().mean().sqrt())


def _block(cfg, device, seed: int):
    """Layer 0's parameters (serving types) as fp32 tensors on device."""
    defs = X.mlstm_defs(cfg)
    flat = S.init_params(defs, seed, device,
                         lambda d: T.serving_dtype(cfg, d))
    return {k: t.float() for k, t in flat.items()}


def _run(cfg, flat, x, dtype, device):
    p = SimpleNamespace(**{k: t.to(device=device, dtype=dtype)
                           for k, t in flat.items()})
    xs = x.to(device=device, dtype=dtype)
    terms = {}
    with torch.no_grad():
        out, _ = X.mlstm_parallel(cfg, p, xs, terms=terms)
        st = X.mlstm_zero_state(xs.shape[0], cfg.num_heads, cfg.hd(),
                                device)
        if dtype == torch.float64:
            st = tuple(t.double() for t in st)
        ys = []
        for t in range(xs.shape[1]):
            y, st = X.mlstm_step(cfg, p, xs[:, t:t + 1], st)
            ys.append(y)
    terms["out"] = out
    terms["out_steps"] = torch.cat(ys, 1)
    return {k: v.double().cpu() for k, v in terms.items()}


def _errors(run, exact):
    out = {}
    for k, want in exact.items():
        out[k] = _rms(run[k] - want) / max(_rms(want), 1e-300)
    y, want = run["out"], exact["out"]
    calm = want.abs() <= 10 * _rms(want)
    err = (y - want).square()
    out["out_calm_share"] = float(calm.double().mean())
    out["out_calm_rms_rel"] = float(err[calm].mean().sqrt()) / _rms(want)
    out["out_wild_sq_err_share"] = float(err[~calm].sum() / err.sum()) \
        if bool((~calm).any()) else 0.0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--positions", type=int, default=256)
    ap.add_argument("--perms", type=int, default=4)
    ap.add_argument("--cpu-only", action="store_true",
                    help="draw on the CPU and skip the card's run")
    args = ap.parse_args(argv)
    cfg = get_config("xlstm-1.3b")
    cpu = torch.device("cpu")
    if args.cpu_only:
        dev = cpu
    elif not torch.cuda.is_available():
        print("no CUDA device (pass --cpu-only for the CPU runs alone)")
        return 1
    else:
        dev = torch.device("cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    flat = _block(cfg, dev, args.seed)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((2, args.positions, cfg.d_model), generator=gen,
                    device=dev)
    flat = {k: t.cpu() for k, t in flat.items()}
    x = x.cpu()
    t0 = time.time()
    exact = _run(cfg, flat, x, torch.float64, cpu)
    runs = {}
    if dev.type == "cuda":
        runs["card fp32"] = _run(cfg, flat, x, torch.float32, dev)
        runs["card fp64"] = _run(cfg, flat, x, torch.float64, dev)
    runs["cpu fp32"] = _run(cfg, flat, x, torch.float32, cpu)
    hd = cfg.hd()
    g = torch.Generator().manual_seed(args.seed + 1)
    for i in range(args.perms):
        perm = torch.randperm(hd, generator=g)
        moved = dict(flat, wq=flat["wq"][..., perm], wk=flat["wk"][..., perm])
        run = _run(cfg, moved, x, torch.float32, cpu)
        # q, k and the products over hd: compare in the original order
        inv = torch.argsort(perm)
        for k in ("q", "k", "ks", "n_in"):
            run[k] = run[k][..., inv]
        for k in ("kv", "c_in"):
            run[k] = run[k][..., inv, :]
        runs[f"cpu fp32, hd permuted {i}"] = run
    info = {"config": "xlstm-1.3b layer 0", "positions": args.positions,
            "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "cpu", "torch": torch.__version__,
            "opt_einsum": torch.backends.opt_einsum.is_available(),
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "exact_out_rms": _rms(exact["out"]),
            "exact_out_max": float(exact["out"].abs().max()),
            "errors": {}}
    for name, run in runs.items():
        info["errors"][name] = _errors(run, exact)
        print(json.dumps({"run": name, **info["errors"][name]}))
        sys.stdout.flush()
    info["seconds"] = time.time() - t0
    print(json.dumps(info))
    return 0


if __name__ == "__main__":
    sys.exit(main())
